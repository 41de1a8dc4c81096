"""CLI `_build_session` dispatch: artifact-folder -> session for every
family, plus config_from_dict roundtrip over all family configs.

Parity target: the reference's per-family ``Inference_*.py`` scripts each
rebuild their own session by hand; here a saved artifact folder must be
enough to reconstruct the session for any family."""

import dataclasses

import numpy as np
import pytest
import jax

from asr_jax.runtime.artifact import save_model
from asr_jax.runtime.metadata import ModelMetadata, config_from_dict


def _roundtrip(cfg):
    return config_from_dict(type(cfg), dataclasses.asdict(cfg))


def test_config_from_dict_roundtrip_all_families():
    from asr_jax.layers.qwen3 import Qwen3Config
    from asr_jax.models.dolphin import DolphinConfig
    from asr_jax.models.firered import FireRedConfig
    from asr_jax.models.fun_asr_nano import FunAsrNanoConfig
    from asr_jax.models.nemotron import NemotronConfig
    from asr_jax.models.paraformer import ParaformerConfig
    from asr_jax.models.parakeet import ParakeetConfig
    from asr_jax.models.qwen_asr import QwenAsrConfig
    from asr_jax.models.sensevoice import SenseVoiceConfig
    from asr_jax.models.whisper import WhisperConfig
    from asr_jax.models.zipformer import ZipformerConfig

    for cfg in (
        SenseVoiceConfig(), WhisperConfig(), ParaformerConfig(),
        ParakeetConfig(), NemotronConfig(), FireRedConfig(),
        DolphinConfig(), FunAsrNanoConfig(), ZipformerConfig(),
        QwenAsrConfig(llm=Qwen3Config(num_layers=2)),
    ):
        assert _roundtrip(cfg) == cfg

    # Non-default nested values survive too.
    from asr_jax.frontend.nemo_mel import NemoMelConfig

    cfg = ParakeetConfig(d_model=96, mel=NemoMelConfig(n_mels=64))
    rt = _roundtrip(cfg)
    assert rt.mel.n_mels == 64 and rt == cfg

    # Unknown keys (older/newer artifacts) are ignored.
    d = dataclasses.asdict(ParaformerConfig())
    d["some_future_field"] = 1
    assert config_from_dict(ParaformerConfig, d) == ParaformerConfig()


def _save(tmp_path, family, params, cfg, **extra):
    folder = tmp_path / family
    folder.mkdir()
    meta = ModelMetadata(
        family=family,
        extra={"config": dataclasses.asdict(cfg), **extra},
    )
    save_model(folder, params, meta)
    return folder


def test_build_session_paraformer_roundtrip(tmp_path):
    from asr_jax.cli import _build_session
    from asr_jax.models import paraformer as pf

    cfg = pf.ParaformerConfig(
        vocab_size=50, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
        num_encoders0=1, num_encoders=1, num_decoders=1, num_decoder_ffn=1,
        fsmn_kernel=5, predictor_kernel=3,
    )
    params = pf.init_params(cfg, jax.random.PRNGKey(0))
    folder = _save(tmp_path, "paraformer", params, cfg)
    sess = _build_session(folder)
    rng = np.random.default_rng(0)
    res = sess.transcribe((rng.standard_normal(16000) * 2000).astype(np.float32))
    assert res.audio_seconds == pytest.approx(1.0)
    assert isinstance(res.token_ids, list)


def test_build_session_parakeet_roundtrip(tmp_path):
    from asr_jax.cli import _build_session
    from asr_jax.frontend.nemo_mel import NemoMelConfig
    from asr_jax.models import parakeet as pk

    cfg = pk.ParakeetConfig(
        vocab_size=40, blank_id=39, d_model=64, num_layers=1, num_heads=4,
        ffn_dim=96, sub_channels=16, dec_hidden=32, lstm_layers=1,
        mel=NemoMelConfig(n_mels=80),
    )
    params = pk.init_params(cfg, jax.random.PRNGKey(1))
    folder = _save(tmp_path, "parakeet", params, cfg)
    sess = _build_session(folder)
    sess.window_seconds = 1.0
    sess.window_samples = 16000
    rng = np.random.default_rng(1)
    res = sess.transcribe((rng.standard_normal(12000) * 0.1).astype(np.float32))
    assert isinstance(res.token_ids, list)


def test_build_session_dolphin_probe(tmp_path):
    from asr_jax.cli import _build_session
    from asr_jax.models import dolphin as dp

    cfg = dp.DolphinConfig(
        vocab_size=80, d_model=32, enc_layers=1, enc_heads=4, enc_ffn=48,
        cgmlp_dim=48, csgu_kernel=7, fusion_kernel=3, dec_layers=1,
        dec_heads=4, dec_ffn=48, sos_id=78, eos_id=79,
        language_token_start=40, language_token_end=50,
        region_token_start=50, region_token_end=60,
        max_target_positions=32,
    )
    params = dp.init_params(cfg, jax.random.PRNGKey(2))
    folder = _save(tmp_path, "dolphin", params, cfg)
    sess = _build_session(folder)
    sess.decode_cfg = dataclasses.replace(sess.decode_cfg, max_new_tokens=6)
    rng = np.random.default_rng(2)
    res = sess.transcribe((rng.standard_normal(8000) * 2000).astype(np.float32))
    assert sess.last_language is not None and 40 <= sess.last_language < 50
    assert sess.last_region is not None and 50 <= sess.last_region < 60
    assert isinstance(res.token_ids, list)


def test_build_session_unknown_family(tmp_path):
    from asr_jax.cli import _build_session

    folder = _save(tmp_path, "martian", {"w": np.zeros((2, 2), np.float32)},
                   dataclasses.make_dataclass("C", [])())
    with pytest.raises(SystemExit):
        _build_session(folder)


def test_build_session_every_family_constructs(tmp_path):
    """Dispatch completeness: every family string accepted by
    _build_session reconstructs a session object from a saved artifact
    (construction only — transcription is covered per-family elsewhere)."""
    import jax
    from asr_jax.cli import _build_session
    from asr_jax.layers import qwen3

    lcfg = qwen3.Qwen3Config(vocab_size=120, hidden=48, num_layers=1, num_heads=4,
                             num_kv_heads=2, head_dim=16, ffn_dim=64, rope_theta=1e4)
    llm = qwen3.init_params(lcfg, jax.random.PRNGKey(9))
    cases = {}

    from asr_jax.models import sensevoice as sv
    cfg = sv.SenseVoiceConfig(vocab_size=64, hidden=32, num_heads=4, head_dim=8,
                              ffn_dim=64, num_encoders0=1, num_encoders=1,
                              num_tp_encoders=1, fsmn_kernel=5)
    cases["sensevoice"] = (sv.init_params(cfg, jax.random.PRNGKey(0)), cfg, {})

    from asr_jax.models import whisper as wh
    cfg = wh.WhisperConfig(vocab_size=80, n_mels=16, d_model=32, encoder_layers=1,
                           decoder_layers=1, num_heads=4, ffn_dim=48,
                           max_source_positions=32, max_target_positions=16,
                           sot_id=70, eot_id=71, no_speech_id=72, no_timestamps_id=73,
                           transcribe_id=74, translate_id=75, first_language_id=60,
                           num_languages=5)
    cases["whisper"] = (wh.init_params(cfg, jax.random.PRNGKey(1)), cfg, {})

    from asr_jax.models import paraformer as pf
    cfg = pf.ParaformerConfig(vocab_size=50, hidden=32, num_heads=4, head_dim=8,
                              ffn_dim=48, num_encoders0=1, num_encoders=1,
                              num_decoders=1, num_decoder_ffn=1, fsmn_kernel=5,
                              predictor_kernel=3)
    pfp = pf.init_params(cfg, jax.random.PRNGKey(2))
    cases["paraformer_streaming"] = (pfp, cfg, {})

    from asr_jax.frontend.nemo_mel import NemoMelConfig
    from asr_jax.models import nemotron as nm
    cfg = nm.NemotronConfig(vocab_size=30, d_model=32, num_layers=1, num_heads=4,
                            ffn_dim=48, conv_kernel=5, sub_channels=8, pred_hidden=16,
                            joint_hidden=16, prompt_hidden=16, lstm_layers=1,
                            num_prompts=4, left_context=6, right_context=3,
                            mel=NemoMelConfig(n_mels=40))
    nmp = nm.init_params(cfg, jax.random.PRNGKey(3))
    cases["nemotron"] = (nmp, cfg, {})
    cases["nemotron_streaming"] = (nmp, cfg, {})

    from asr_jax.models import firered as fr
    cfg = fr.FireRedConfig(vocab_size=60, d_model=32, enc_layers=1, enc_heads=4,
                           conv_kernel=9, dec_layers=1, dec_heads=4, dec_ffn=48,
                           max_target_positions=16)
    cases["firered"] = (fr.init_params(cfg, jax.random.PRNGKey(4)), cfg, {})

    from asr_jax.models import dolphin as dp
    cfg = dp.DolphinConfig(vocab_size=60, d_model=32, enc_layers=1, enc_heads=4,
                           enc_ffn=48, cgmlp_dim=48, csgu_kernel=5, fusion_kernel=3,
                           dec_layers=1, dec_heads=4, dec_ffn=48, sos_id=50, eos_id=51,
                           max_target_positions=16)
    dpp = dp.init_params(cfg, jax.random.PRNGKey(5))
    cases["dolphin_streaming"] = (dpp, cfg, {})

    from asr_jax.models import fun_asr_nano as fn
    cfg = fn.FunAsrNanoConfig(hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
                              num_encoders0=1, num_encoders=1, num_tp_encoders=1,
                              fsmn_kernel=5, adaptor_hidden=48, adaptor_blocks=1,
                              adaptor_heads=4, adaptor_ffn=64, ctc_hidden=32,
                              ctc_blocks=1, ctc_heads=4, ctc_ffn=48, ctc_vocab=50,
                              llm=lcfg, eot_id=-1)
    fnp = fn.init_params(cfg, jax.random.PRNGKey(6))
    cases["fun_asr_nano"] = (fnp, cfg, {})
    cases["fun_asr_nano_llm"] = ({"encoder": fnp, "llm": llm}, cfg, {})

    from asr_jax.models import zipformer as zf
    cfg = zf.ZipformerConfig(vocab_size=40, downsampling_factor=(1, 2),
                             num_encoder_layers=(1, 1), encoder_dim=(32, 48),
                             query_head_dim=(8, 8), pos_head_dim=(4, 4),
                             value_head_dim=(8, 8), num_heads=(2, 2),
                             feedforward_dim=(48, 64), cnn_module_kernel=(7, 7),
                             chunk_size=8, left_context_frames=16,
                             sub_layer1=4, sub_layer2=8, sub_layer3=16,
                             decoder_dim=16, joiner_dim=16, context_size=2,
                             decoder_conv_groups=4)
    cases["x_asr"] = (zf.init_params(cfg, jax.random.PRNGKey(7)), cfg, {})

    from asr_jax.models import qwen_asr as qa
    cfg = qa.QwenAsrConfig(n_mels=16, tower_dim=32, tower_layers=1, tower_heads=4,
                           tower_ffn=48, downsample_hidden=8, chunks_per_window=2,
                           output_dim=lcfg.hidden, llm=lcfg, eot_id=-1)
    qt = qa.init_tower_params(cfg, jax.random.PRNGKey(8))
    cases["qwen_asr"] = ({"tower": qt, "llm": llm}, cfg, {})

    from asr_jax.models import forced_aligner as fa
    acfg = fa.ForcedAlignerConfig(asr=cfg, classify_num=25, segment_ms=80)
    head = {"w": jax.random.normal(jax.random.PRNGKey(10), (lcfg.hidden, 25)) * 0.1}
    cases["qwen_aligner"] = (
        {"tower": qt, "llm": llm, "head": head}, acfg,
        {"special_token_ids": {"timestamp": 110, "audio_start": 111, "audio_end": 112}},
    )

    for family, (params, cfg, extra_meta) in cases.items():
        folder = tmp_path / family
        folder.mkdir()
        meta = ModelMetadata(family=family,
                             extra={"config": dataclasses.asdict(cfg)},
                             **extra_meta)
        save_model(folder, params, meta)
        sess = _build_session(folder)
        assert sess is not None, family


def test_dtype_bf16_serving_cast(tmp_path):
    """--dtype bfloat16: the session is built from a bf16-cast pytree and
    still transcribes (norms/softmax internally f32)."""
    import jax.numpy as jnp

    from asr_jax.cli import _build_session
    from asr_jax.models import sensevoice as sv

    cfg = sv.SenseVoiceConfig(
        vocab_size=64, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
        num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5,
    )
    params = sv.init_params(cfg, jax.random.PRNGKey(0))
    folder = tmp_path / "artifact"
    folder.mkdir()
    meta = ModelMetadata(family="sensevoice", extra={"config": dataclasses.asdict(cfg) | {"fbank": None}})
    meta.extra["config"].pop("fbank", None)
    save_model(folder, params, meta)
    sess = _build_session(folder, dtype="bfloat16")
    assert sess.params["encoders"][0]["qkv"]["w"].dtype == jnp.bfloat16
    res = sess.transcribe(np.zeros(8000, np.float32))
    assert res.audio_seconds > 0


def test_cli_multifile_transcribe_with_language_windowed_family(tmp_path):
    """`transcribe --language X a.wav b.wav` on a windowed (transducer-style)
    family must not crash: the batch path gates kwargs on the
    transcribe_batch signature (regression — language was forwarded
    unconditionally into _forward)."""
    import wave

    from asr_jax.cli import main
    from asr_jax.models import paraformer as pf

    cfg = pf.ParaformerConfig(
        vocab_size=50, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
        num_encoders0=1, num_encoders=1, num_decoders=1, num_decoder_ffn=1,
        fsmn_kernel=5, predictor_kernel=3,
    )
    params = pf.init_params(cfg, jax.random.PRNGKey(0))
    folder = _save(tmp_path, "paraformer", params, cfg)

    rng = np.random.default_rng(0)
    paths = []
    for i in range(2):
        p = tmp_path / f"a{i}.wav"
        with wave.open(str(p), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((rng.standard_normal(8000) * 1000).astype(np.int16).tobytes())
        paths.append(str(p))

    rc = main(["--platform", "cpu", "transcribe", "--model-dir", str(folder),
               "--language", "zh", *paths])
    assert rc == 0


def test_dolphin_language_catalog_and_named_forcing(tmp_path):
    """VERDICT r2 item 5: --language on a Dolphin artifact resolves NAMES
    (code, alias, Alias-Region compound) to forced prompt token ids via
    the catalog scanned from the vocab at build time; unmapped names raise
    with the catalog listed."""
    import dataclasses as dc

    import pytest

    from asr_jax.cli import _build_session
    from asr_jax.export import dolphin_language_catalog
    from asr_jax.models import dolphin as dp

    # synthetic vocab with the reference's token structure:
    # ... <asr> <zh> <ja> <CN> <SICHUAN> <notimestamp> ...
    tokens = [f"tok{i}" for i in range(40)]
    tokens += ["<asr>", "<zh>", "<ja>", "<ct>", "<CN>", "<TW>", "<SICHUAN>",
               "<notimestamp>"]
    tokens += [f"tok{i}" for i in range(40, 60)]
    cat = dolphin_language_catalog(tokens)
    assert cat["languages"] == {"zh": 41, "ja": 42, "ct": 43}
    assert cat["regions"] == {"CN": 44, "TW": 45, "SICHUAN": 46}
    assert cat["asr_id"] == 40 and cat["notimestamp_id"] == 47
    assert cat["aliases"]["Japanese"] == "ja"
    assert cat["aliases"]["Cantonese"] == "ct"

    cfg = dp.DolphinConfig(
        vocab_size=80, d_model=32, enc_layers=1, enc_heads=4, enc_ffn=48,
        cgmlp_dim=48, csgu_kernel=7, fusion_kernel=3, dec_layers=1,
        dec_heads=4, dec_ffn=48, sos_id=78, eos_id=79,
        max_target_positions=32,
    )
    params = dp.init_params(cfg, jax.random.PRNGKey(3))
    folder = _save(tmp_path, "dolphin", params, cfg,
                   dolphin_language_catalog=cat)

    # code only -> forced language, probed region
    sess = _build_session(folder, language="ja")
    assert (sess.language_id, sess.region_id) == (42, -2)
    # alias-region compound -> both forced
    sess = _build_session(folder, language="Chinese-Sichuan")
    assert (sess.language_id, sess.region_id) == (41, 46)
    # model-value spelling
    sess = _build_session(folder, language="zh-TW")
    assert (sess.language_id, sess.region_id) == (41, 45)
    # auto keeps probing
    sess = _build_session(folder, language="auto")
    assert (sess.language_id, sess.region_id) == (-1, -2)
    # and the forced session actually transcribes with the forced prompt
    sess = _build_session(folder, language="ja")
    sess.decode_cfg = dc.replace(sess.decode_cfg, max_new_tokens=4)
    rng = np.random.default_rng(5)
    res = sess.transcribe((rng.standard_normal(8000) * 2000).astype(np.float32))
    assert isinstance(res.token_ids, list)

    with pytest.raises(KeyError, match="catalog"):
        _build_session(folder, language="Klingon")
    with pytest.raises(KeyError, match="region"):
        _build_session(folder, language="zh-MARS")
    # artifact built without a vocab: forcing fails loudly, not silently
    folder2 = _save(tmp_path, "dolphin2", params, cfg)
    (folder2 / "metadata.json").write_text(
        (folder2 / "metadata.json").read_text().replace('"dolphin2"', '"dolphin"'))
    with pytest.raises(KeyError, match="rebuild with --vocab"):
        _build_session(folder2, language="ja")


def test_cli_optimize_plan_roundtrip_qwen(tmp_path):
    """`asr_jax optimize --plan` applies the per-component serving recipe
    (reference ``Qwen_ASR/Optimize_ONNX.py:139-161``: Encoder Q8 + Main Q4
    + Embed quantized) and the resulting artifact loads + transcribes
    through the normal session path with QuantizedLinear /
    QuantizedEmbedding leaves intact."""
    import json

    from asr_jax.cli import _build_session, main
    from asr_jax.layers import qwen3
    from asr_jax.models import qwen_asr as qa
    from asr_jax.quant.quantize import QuantizedEmbedding, QuantizedLinear
    from asr_jax.runtime.artifact import load_model

    lcfg = qwen3.Qwen3Config(vocab_size=120, hidden=48, num_layers=1, num_heads=4,
                             num_kv_heads=2, head_dim=16, ffn_dim=64)
    llm = qwen3.init_params(lcfg, jax.random.PRNGKey(9))
    cfg = qa.QwenAsrConfig(n_mels=16, tower_dim=32, tower_layers=1, tower_heads=4,
                           tower_ffn=48, downsample_hidden=8, chunks_per_window=2,
                           output_dim=lcfg.hidden, llm=lcfg, eot_id=-1)
    qt = qa.init_tower_params(cfg, jax.random.PRNGKey(8))
    folder = _save(tmp_path, "qwen_asr", {"tower": qt, "llm": llm}, cfg)

    plan = {
        "plans": {
            "tower": {"method": "q8", "block": 8, "min_size": 1024,
                      "refine_iters": 0},
            "llm": {"method": "q4", "pack": True, "block": 8, "min_size": 1024,
                    "refine_iters": 0, "embeddings": True},
        },
        "assign": [["tower/*", "tower"], ["llm/*", "llm"], ["*", "tower"]],
    }
    plan_path = tmp_path / "plan.json"
    plan_path.write_text(json.dumps(plan), encoding="utf-8")
    out = tmp_path / "optimized"
    assert main(["optimize", "--model-dir", str(folder), "--plan", str(plan_path),
                 "--out", str(out)]) == 0

    params, meta = load_model(out)
    assert isinstance(params["llm"]["embed"], QuantizedEmbedding)
    qkv_or_q = params["llm"]["layers"][0]["attn"]["q"]["w"]
    assert isinstance(qkv_or_q, QuantizedLinear) and qkv_or_q.bits == 4
    assert meta.extra["optimizer_plan"]["assign"][0] == ["tower/*", "tower"]

    sess = _build_session(out)
    sess.decode_cfg = dataclasses.replace(sess.decode_cfg, max_new_tokens=4)
    rng = np.random.default_rng(3)
    res = sess.transcribe((rng.standard_normal(8000) * 0.1).astype(np.float32))
    assert isinstance(res.token_ids, list) and len(res.token_ids) >= 1
