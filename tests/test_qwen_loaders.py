"""Qwen-tower checkpoint loaders (Qwen3-ASR / ForcedAligner / Fun-ASR-Nano):
state-dict mapping vs an independent torch re-derivation of the tower math,
geometry derivation from shapes, and builder -> CLI session round trips."""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from asr_jax.models import qwen_asr as qa

TOWER = dict(d=32, layers=2, heads=4, ffn=48, ds=8, n_mels=16)


def _tower_sd(rng):
    """Synthetic ``audio_tower.*`` state dict (names from the reference
    modeling tree, ``Qwen_ASR/Export_Qwen_ASR.py:373-436``)."""
    t = lambda *s: torch.tensor((rng.standard_normal(s) * 0.05).astype(np.float32))
    d, ds, ffn, n_mels = TOWER["d"], TOWER["ds"], TOWER["ffn"], TOWER["n_mels"]
    freq = n_mels
    for _ in range(3):
        freq = (freq + 1) // 2
    sd = {
        "audio_tower.conv2d1.weight": t(ds, 1, 3, 3),
        "audio_tower.conv2d1.bias": t(ds),
        "audio_tower.conv2d2.weight": t(ds, ds, 3, 3),
        "audio_tower.conv2d2.bias": t(ds),
        "audio_tower.conv2d3.weight": t(ds, ds, 3, 3),
        "audio_tower.conv2d3.bias": t(ds),
        "audio_tower.conv_out.weight": t(d, ds * freq),
        "audio_tower.ln_post.weight": t(d), "audio_tower.ln_post.bias": t(d),
        "audio_tower.proj1.weight": t(d, d), "audio_tower.proj1.bias": t(d),
        "audio_tower.proj2.weight": t(24, d), "audio_tower.proj2.bias": t(24),
    }
    for i in range(TOWER["layers"]):
        p = f"audio_tower.layers.{i}"
        sd.update({
            f"{p}.self_attn.q_proj.weight": t(d, d), f"{p}.self_attn.q_proj.bias": t(d),
            f"{p}.self_attn.k_proj.weight": t(d, d), f"{p}.self_attn.k_proj.bias": t(d),
            f"{p}.self_attn.v_proj.weight": t(d, d), f"{p}.self_attn.v_proj.bias": t(d),
            f"{p}.self_attn.out_proj.weight": t(d, d), f"{p}.self_attn.out_proj.bias": t(d),
            f"{p}.self_attn_layer_norm.weight": t(d), f"{p}.self_attn_layer_norm.bias": t(d),
            f"{p}.fc1.weight": t(ffn, d), f"{p}.fc1.bias": t(ffn),
            f"{p}.fc2.weight": t(d, ffn), f"{p}.fc2.bias": t(d),
            f"{p}.final_layer_norm.weight": t(d), f"{p}.final_layer_norm.bias": t(d),
        })
    return sd


def _tiny_cfg():
    from asr_jax.layers.qwen3 import Qwen3Config

    return qa.QwenAsrConfig(
        n_mels=TOWER["n_mels"], tower_dim=TOWER["d"], tower_layers=TOWER["layers"],
        tower_heads=TOWER["heads"], tower_ffn=TOWER["ffn"],
        downsample_hidden=TOWER["ds"], output_dim=24,
        llm=Qwen3Config(vocab_size=64, hidden=24, num_layers=1, num_heads=2,
                        num_kv_heads=1, head_dim=12, ffn_dim=32),
    )


def _torch_tower_forward(sd, mel):
    """Independent torch re-derivation of the tower forward (one full-valid
    window), mirroring reference ``Export_Qwen_ASR.py:797-925``."""
    import torch.nn.functional as F

    d, heads = TOWER["d"], TOWER["heads"]
    hd = d // heads
    chunk = 100
    n_mels = TOWER["n_mels"]
    g = lambda k: sd[f"audio_tower.{k}"]
    x = torch.tensor(mel).reshape(1, -1, chunk, n_mels).permute(1, 0, 3, 2)  # (N,1,M,T)
    for c in ("conv2d1", "conv2d2", "conv2d3"):
        x = F.gelu(F.conv2d(x, g(f"{c}.weight"), g(f"{c}.bias"), stride=2, padding=1))
    n = x.shape[0]
    x = x.permute(0, 3, 1, 2).reshape(n, 13, -1) @ g("conv_out.weight").T
    # Whisper-style sin/cos-concat sinusoid positions, rows 0..12.
    inc = np.log(10000.0) / (d // 2 - 1)
    inv = np.exp(-inc * np.arange(d // 2, dtype=np.float64))
    ang = np.arange(13, dtype=np.float64)[:, None] * inv[None, :]
    pos = torch.tensor(np.concatenate([np.sin(ang), np.cos(ang)], 1), dtype=torch.float32)
    h = (x + pos).reshape(1, -1, d)  # one window (104 tokens)
    for i in range(TOWER["layers"]):
        p = f"layers.{i}"
        y = F.layer_norm(h, (d,), g(f"{p}.self_attn_layer_norm.weight"), g(f"{p}.self_attn_layer_norm.bias"))
        q = (y @ g(f"{p}.self_attn.q_proj.weight").T + g(f"{p}.self_attn.q_proj.bias"))
        k = (y @ g(f"{p}.self_attn.k_proj.weight").T + g(f"{p}.self_attn.k_proj.bias"))
        v = (y @ g(f"{p}.self_attn.v_proj.weight").T + g(f"{p}.self_attn.v_proj.bias"))
        s = h.shape[1]
        q = q.view(1, s, heads, hd).transpose(1, 2) * (hd ** -0.5)
        k = k.view(1, s, heads, hd).transpose(1, 2)
        v = v.view(1, s, heads, hd).transpose(1, 2)
        a = torch.softmax(q @ k.transpose(-1, -2), dim=-1) @ v
        a = a.transpose(1, 2).reshape(1, s, d)
        h = h + a @ g(f"{p}.self_attn.out_proj.weight").T + g(f"{p}.self_attn.out_proj.bias")
        y = F.layer_norm(h, (d,), g(f"{p}.final_layer_norm.weight"), g(f"{p}.final_layer_norm.bias"))
        y = F.gelu(y @ g(f"{p}.fc1.weight").T + g(f"{p}.fc1.bias"))
        h = h + y @ g(f"{p}.fc2.weight").T + g(f"{p}.fc2.bias")
    h = F.layer_norm(h, (d,), g("ln_post.weight"), g("ln_post.bias"))
    h = F.gelu(h @ g("proj1.weight").T + g("proj1.bias"))
    h = h @ g("proj2.weight").T + g("proj2.bias")
    return h.numpy()


def test_tower_mapping_matches_torch_rederivation():
    from asr_jax.loaders.qwen_asr_hf import tower_params_from_state_dict

    rng = np.random.default_rng(11)
    sd = _tower_sd(rng)
    cfg = _tiny_cfg()
    tower = tower_params_from_state_dict(sd, cfg)

    frames = cfg.chunk_frames * cfg.chunks_per_window  # one full window
    mel = (rng.standard_normal((1, frames, cfg.n_mels)) * 0.5).astype(np.float32)
    ours, valid = qa.encode_audio(tower, cfg, jnp.asarray(mel), jnp.asarray([frames], np.int32))
    ref = _torch_tower_forward(sd, mel)
    assert int(valid[0]) == cfg.tokens_per_window
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=2e-4, atol=2e-4)


def _write_snapshot(tmp_path, sd_extra=None, classify=None):
    """Write a synthetic HF snapshot dir: config.json + model.safetensors
    with thinker.* names (text half from a tiny HF Qwen3)."""
    transformers = pytest.importorskip("transformers")
    from safetensors.numpy import save_file

    cfg = _tiny_cfg()
    hf_text = dict(
        vocab_size=cfg.llm.vocab_size, hidden_size=cfg.llm.hidden,
        intermediate_size=cfg.llm.ffn_dim, num_hidden_layers=cfg.llm.num_layers,
        num_attention_heads=cfg.llm.num_heads, num_key_value_heads=cfg.llm.num_kv_heads,
        head_dim=cfg.llm.head_dim, rope_theta=cfg.llm.rope_theta,
        tie_word_embeddings=True, rms_norm_eps=1e-6,
    )
    torch.manual_seed(1)
    text_model = transformers.Qwen3ForCausalLM(transformers.Qwen3Config(**hf_text)).eval()
    sd = {f"thinker.{k}": v for k, v in _tower_sd(np.random.default_rng(11)).items()}
    for k, v in text_model.state_dict().items():
        if k == "lm_head.weight":
            continue  # tied
        sd[f"thinker.{k}"] = v
    if classify:
        sd["thinker.lm_head.weight"] = torch.randn(classify, cfg.llm.hidden) * 0.05
    if sd_extra:
        sd.update(sd_extra)
    src = tmp_path / "ckpt"
    src.mkdir(exist_ok=True)
    save_file({k: np.ascontiguousarray(v.numpy()) for k, v in sd.items()},
              str(src / "model.safetensors"))
    (src / "config.json").write_text(json.dumps({
        "thinker_config": {
            "audio_config": {
                "num_mel_bins": cfg.n_mels, "d_model": cfg.tower_dim,
                "encoder_layers": cfg.tower_layers,
                "encoder_attention_heads": cfg.tower_heads,
                "encoder_ffn_dim": cfg.tower_ffn,
                "downsample_hidden_size": cfg.downsample_hidden,
                "n_window": 50, "n_window_infer": 800,
                "output_dim": cfg.output_dim,
            },
            "text_config": hf_text | {"tie_word_embeddings": classify is None},
        },
        "support_languages": ["English", "Chinese"],
    }))
    return src, cfg, text_model


def test_load_qwen_asr_dir_and_builder(tmp_path):
    from asr_jax import export as ex
    from asr_jax.loaders.qwen_asr_hf import load_qwen_asr_dir
    from asr_jax.runtime.metadata import ModelMetadata

    src, want, _ = _write_snapshot(tmp_path)
    tower, llm, cfg = load_qwen_asr_dir(src)
    assert cfg.tower_layers == want.tower_layers
    assert cfg.chunks_per_window == want.chunks_per_window == 8
    assert cfg.llm.hidden == want.llm.hidden
    assert llm["embed"].shape == (want.llm.vocab_size, want.llm.hidden)
    assert tower["conv_out"]["w"].shape[1] == want.tower_dim

    out = ex.build_qwen_asr_artifact(src, tmp_path / "artifact")
    meta = ModelMetadata.load(out)
    assert meta.family == "qwen_asr"
    from asr_jax.cli import _build_session

    sess = _build_session(out)
    assert type(sess).__name__ == "QwenAsrSession"


def test_load_aligner_dir_and_builder(tmp_path):
    from asr_jax import export as ex
    from asr_jax.loaders.qwen_asr_hf import load_aligner_dir
    from asr_jax.runtime.metadata import ModelMetadata

    src, want, _ = _write_snapshot(tmp_path, classify=25)
    tower, llm, head, cfg = load_aligner_dir(src)
    assert cfg.classify_num == 25
    assert head["w"].shape == (want.llm.hidden, 25)

    out = ex.build_qwen_aligner_artifact(src, tmp_path / "artifact")
    meta = ModelMetadata.load(out)
    assert meta.family == "qwen_aligner"
    assert meta.extra["timestamp_tokens_per_word"] == 2


NANO = dict(hidden=32, heads=4, head_dim=8, ffn=48, n0=1, n=2, tp=1, k=5,
            ad=24, ad_blocks=1, ad_ffn=40, ctc_h=32, ctc_blocks=1, ctc_ffn=40, vocab=70)


def _nano_sd(rng):
    from tests.test_loaders import _sanm_sd

    t = lambda *s: torch.tensor((rng.standard_normal(s) * 0.05).astype(np.float32))
    h, k = NANO["hidden"], NANO["k"]
    fs = 80 * 7  # n_mels * lfr_m
    sd = {}
    sd.update(_sanm_sd("audio_encoder.encoders0.0", fs, h, NANO["ffn"], k, rng))
    for i in range(NANO["n"]):
        sd.update(_sanm_sd(f"audio_encoder.encoders.{i}", h, h, NANO["ffn"], k, rng))
    for i in range(NANO["tp"]):
        sd.update(_sanm_sd(f"audio_encoder.tp_encoders.{i}", h, h, NANO["ffn"], k, rng))
    sd["audio_encoder.after_norm.weight"] = t(h)
    sd["audio_encoder.after_norm.bias"] = t(h)
    sd["audio_encoder.tp_norm.weight"] = t(h)
    sd["audio_encoder.tp_norm.bias"] = t(h)

    def block(prefix, dim, ffn):
        sd.update({
            f"{prefix}.norm1.weight": t(dim), f"{prefix}.norm1.bias": t(dim),
            f"{prefix}.self_attn.linear_q.weight": t(dim, dim), f"{prefix}.self_attn.linear_q.bias": t(dim),
            f"{prefix}.self_attn.linear_k.weight": t(dim, dim), f"{prefix}.self_attn.linear_k.bias": t(dim),
            f"{prefix}.self_attn.linear_v.weight": t(dim, dim), f"{prefix}.self_attn.linear_v.bias": t(dim),
            f"{prefix}.self_attn.linear_out.weight": t(dim, dim), f"{prefix}.self_attn.linear_out.bias": t(dim),
            f"{prefix}.norm2.weight": t(dim), f"{prefix}.norm2.bias": t(dim),
            f"{prefix}.feed_forward.w_1.weight": t(ffn, dim), f"{prefix}.feed_forward.w_1.bias": t(ffn),
            f"{prefix}.feed_forward.w_2.weight": t(dim, ffn), f"{prefix}.feed_forward.w_2.bias": t(dim),
        })

    sd["audio_adaptor.linear1.weight"] = t(NANO["ad"], h)
    sd["audio_adaptor.linear1.bias"] = t(NANO["ad"])
    sd["audio_adaptor.linear2.weight"] = t(NANO["ad"], NANO["ad"])
    sd["audio_adaptor.linear2.bias"] = t(NANO["ad"])
    for i in range(NANO["ad_blocks"]):
        block(f"audio_adaptor.blocks.{i}", NANO["ad"], NANO["ad_ffn"])
    sd["ctc_decoder.linear1.weight"] = t(NANO["ctc_h"], h)
    sd["ctc_decoder.linear1.bias"] = t(NANO["ctc_h"])
    sd["ctc_decoder.linear2.weight"] = t(NANO["ctc_h"], NANO["ctc_h"])
    sd["ctc_decoder.linear2.bias"] = t(NANO["ctc_h"])
    for i in range(NANO["ctc_blocks"]):
        block(f"ctc_decoder.blocks.{i}", NANO["ctc_h"], NANO["ctc_ffn"])
    sd["ctc.ctc_lo.weight"] = t(NANO["vocab"], NANO["ctc_h"])
    sd["ctc.ctc_lo.bias"] = t(NANO["vocab"])

    # Tiny Qwen3 LLM half under llm.*
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(2)
    llm = transformers.Qwen3ForCausalLM(transformers.Qwen3Config(
        vocab_size=64, hidden_size=NANO["ad"], intermediate_size=32,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
        head_dim=12, tie_word_embeddings=True)).eval()
    for kk, v in llm.state_dict().items():
        if kk != "lm_head.weight":
            sd[f"llm.{kk}"] = v
    return sd


def test_fun_asr_nano_loader_and_builder(tmp_path):
    from asr_jax import export as ex
    from asr_jax.cli import _build_session
    from asr_jax.loaders import funasr
    from asr_jax.runtime.metadata import ModelMetadata

    rng = np.random.default_rng(5)
    sd = _nano_sd(rng)
    cfg = funasr.fun_asr_nano_config_from_state_dict(
        sd, num_heads=NANO["heads"], head_dim=NANO["head_dim"],
        adaptor_heads=2, ctc_heads=2, blank_id=NANO["vocab"] - 1)
    assert (cfg.hidden, cfg.num_encoders, cfg.num_tp_encoders) == (NANO["hidden"], NANO["n"], NANO["tp"])
    assert (cfg.adaptor_blocks, cfg.ctc_blocks, cfg.ctc_vocab) == (NANO["ad_blocks"], NANO["ctc_blocks"], NANO["vocab"])
    assert cfg.llm.hidden == NANO["ad"]
    params = funasr.fun_asr_nano_params_from_state_dict(sd, cfg)
    assert params["adaptor"]["blocks"][0]["qkv"]["w"].shape == (NANO["ad"], 3 * NANO["ad"])

    # CTC head forward with loaded weights.
    from asr_jax.models import fun_asr_nano as nano

    audio = jnp.asarray((rng.standard_normal((1, 9600)) * 2000).astype(np.float32))
    toks, counts = nano.forward_ctc(params, cfg, audio, jnp.asarray([9600], np.int32))
    assert toks.shape[0] == 1 and int(counts[0]) >= 0

    # Builder end-to-end (CTC family) through the CLI.
    src = tmp_path / "ckpt"
    src.mkdir()
    torch.save(sd, src / "model.pt")
    out = ex.build_fun_asr_nano_artifact(src, tmp_path / "artifact", cfg=cfg)
    meta = ModelMetadata.load(out)
    assert meta.family == "fun_asr_nano"
    sess = _build_session(out)
    res = sess.transcribe((rng.standard_normal(4800) * 0.05).astype(np.float32))
    assert isinstance(res.text, str)

    # LLM family artifact carries both halves.
    out2 = ex.build_fun_asr_nano_artifact(src, tmp_path / "artifact_llm", head="llm", cfg=cfg)
    meta2 = ModelMetadata.load(out2)
    assert meta2.family == "fun_asr_nano_llm"
    from asr_jax.runtime.artifact import load_model

    params2, _ = load_model(out2)
    assert "encoder" in params2 and "llm" in params2
