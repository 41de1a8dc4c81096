"""Artifact builders: synthetic checkpoint folders -> self-describing
artifacts consumable by the CLI/sessions."""

import json

import numpy as np
import pytest
import jax

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from asr_jax import export as ex
from asr_jax.runtime.metadata import ModelMetadata


def test_build_whisper_artifact(tmp_path):
    hf_cfg = transformers.WhisperConfig(
        vocab_size=100, d_model=32, encoder_layers=1, decoder_layers=1,
        encoder_attention_heads=4, decoder_attention_heads=4,
        encoder_ffn_dim=64, decoder_ffn_dim=64, num_mel_bins=16,
        max_source_positions=40, max_target_positions=24,
        decoder_start_token_id=1, eos_token_id=2, pad_token_id=3,
    )
    torch.manual_seed(0)
    model = transformers.WhisperForConditionalGeneration(hf_cfg)
    src = tmp_path / "ckpt"
    src.mkdir()
    model.save_pretrained(src, safe_serialization=True)
    (src / "generation_config.json").write_text(json.dumps({
        "suppress_tokens": [5, 6], "begin_suppress_tokens": [7],
        "lang_to_id": {"<|en|>": 10, "<|zh|>": 11},
        "no_timestamps_token_id": 21,
        "task_to_id": {"transcribe": 20, "translate": 19},
    }))
    out = ex.build_whisper_artifact(src, tmp_path / "artifact")
    meta = ModelMetadata.load(out)
    assert meta.family == "whisper"
    assert meta.extra["suppress_tokens"] == [5, 6]
    assert meta.resolve_language("en").prompt_token_id == 10
    assert meta.special_token_ids["transcribe"] == 20
    from asr_jax.runtime.artifact import load_model

    params, _ = load_model(out)
    assert params["decoder"]["embed"].shape == (100, 32)


def test_build_sensevoice_artifact(tmp_path):
    from asr_jax.models import sensevoice as sv
    from tests.test_loaders import SV_CFG, _sensevoice_sd

    rng = np.random.default_rng(0)
    sd = {k: v for k, v in _sensevoice_sd(SV_CFG, rng).items()}
    src = tmp_path / "SenseVoiceSmall"
    src.mkdir()
    torch.save(sd, src / "model.pt")
    f = SV_CFG.feature_size
    (src / "am.mvn").write_text(
        "<Nnet>\n<AddShift> %d %d\n<LearnRateCoef> 0 [ %s ]\n"
        "<Rescale> %d %d\n<LearnRateCoef> 0 [ %s ]\n</Nnet>\n"
        % (f, f, " ".join(["-0.5"] * f), f, f, " ".join(["2.0"] * f))
    )
    (src / "chn_jpn_yue_eng_ko_spectok.bpe.model").write_bytes(b"")
    out = ex.build_sensevoice_artifact(src, tmp_path / "artifact", cfg=SV_CFG)
    meta = ModelMetadata.load(out)
    assert meta.family == "sensevoice"
    assert meta.resolve_language("Mandarin").prompt_token_id == 3
    assert meta.tokenizer["kind"] == "sentencepiece"


def test_build_paraformer_artifact_end_to_end(tmp_path):
    """Synthetic FunASR folder -> artifact -> CLI session -> transcribe."""
    from tests.test_loaders import PF_CFG, _paraformer_sd
    from asr_jax.cli import _build_session

    rng = np.random.default_rng(3)
    src = tmp_path / "paraformer-large"
    src.mkdir()
    torch.save(_paraformer_sd(PF_CFG, rng), src / "model.pt")
    f = PF_CFG.feature_size
    (src / "am.mvn").write_text(
        "<Nnet>\n<AddShift> %d %d\n<LearnRateCoef> 0 [ %s ]\n"
        "<Rescale> %d %d\n<LearnRateCoef> 0 [ %s ]\n</Nnet>\n"
        % (f, f, " ".join(["-0.5"] * f), f, f, " ".join(["2.0"] * f))
    )
    (src / "tokens.txt").write_text("\n".join(f"tok{i}" for i in range(PF_CFG.vocab_size)))
    out = ex.build_paraformer_artifact(src, tmp_path / "artifact", cfg=PF_CFG, decode_mode="en")
    meta = ModelMetadata.load(out)
    assert meta.family == "paraformer" and meta.tokenizer["kind"] == "vocab_txt"

    sess = _build_session(out)
    res = sess.transcribe((rng.standard_normal(16000) * 2000).astype(np.float32))
    assert res.audio_seconds == 1.0 and isinstance(res.text, str)

    out2 = ex.build_paraformer_artifact(src, tmp_path / "stream", cfg=PF_CFG, streaming=True)
    assert ModelMetadata.load(out2).family == "paraformer_streaming"


def test_build_firered_artifact_end_to_end(tmp_path):
    import jax.numpy as jnp

    from asr_jax.cli import _build_session
    from tests.test_firered import TINY, _firered_sd

    rng = np.random.default_rng(3)
    sd = _firered_sd(TINY, rng)
    src = tmp_path / "ckpt"
    src.mkdir()
    torch.save({"args": {"n_layers_enc": TINY.enc_layers}, "model_state_dict": sd},
               src / "model.pth.tar")
    dim = TINY.n_mels
    x = rng.standard_normal((50, dim)) + 2.0
    row1 = " ".join(f"{v:.6f}" for v in x.sum(0)) + " 50"
    row2 = " ".join(f"{v:.6f}" for v in (x * x).sum(0)) + " 0"
    (src / "cmvn.ark").write_text(f" [ {row1}\n{row2} ]\n")
    (src / "dict.txt").write_text(
        "\n".join(f"tok{i} {i}" for i in range(TINY.vocab_size)) + "\n")

    out = ex.build_firered_artifact(src, tmp_path / "artifact",
                                    cfg=TINY.__class__(**{**TINY.__dict__}))
    meta = ModelMetadata.load(out)
    assert meta.family == "firered"
    assert meta.tokenizer["kind"] == "firered_dict"
    sess = _build_session(out)
    audio = (rng.standard_normal(4800) * 0.05).astype(np.float32)  # [-1,1] pcm
    res = sess.transcribe(audio)
    assert isinstance(res.text, str)
    assert res.audio_seconds > 0
