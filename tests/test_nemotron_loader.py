"""Nemotron .nemo loader: archive reading (tar + yaml, NeMo-free), geometry
extraction with att-context selection, state-dict mapping (prompt-kernel
one-hot collapse checked exactly), and the builder -> CLI session round trip
for both offline and streaming families."""

import tarfile

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

from asr_jax.frontend.nemo_mel import NemoMelConfig
from asr_jax.models import nemotron as nm

TINY = nm.NemotronConfig(
    vocab_size=30, d_model=64, num_layers=2, num_heads=4, ffn_dim=96,
    conv_kernel=5, sub_channels=16, pred_hidden=32, joint_hidden=32,
    prompt_hidden=32, lstm_layers=1, num_prompts=8, left_context=6,
    right_context=3, mel=NemoMelConfig(n_mels=80),
)


def _nemotron_sd(cfg, rng):
    """Synthetic NeMo state dict (names from the reference's buffer reads,
    ``Export_Nemotron_ASR.py:456-590,833-849``)."""
    t = lambda *s: torch.tensor((rng.standard_normal(s) * 0.05).astype(np.float32))
    d, f, ch = cfg.d_model, cfg.ffn_dim, cfg.sub_channels
    sd = {
        "preprocessor.featurizer.window": t(cfg.mel.win_length),
        "preprocessor.featurizer.fb": t(1, cfg.mel.n_fft // 2 + 1, cfg.mel.n_mels),
        "encoder.pre_encode.conv.0.weight": t(ch, 1, 3, 3),
        "encoder.pre_encode.conv.0.bias": t(ch),
        "encoder.pre_encode.conv.2.weight": t(ch, 1, 3, 3),
        "encoder.pre_encode.conv.2.bias": t(ch),
        "encoder.pre_encode.conv.3.weight": t(ch, ch, 1, 1),
        "encoder.pre_encode.conv.3.bias": t(ch),
        "encoder.pre_encode.conv.5.weight": t(ch, 1, 3, 3),
        "encoder.pre_encode.conv.5.bias": t(ch),
        "encoder.pre_encode.conv.6.weight": t(ch, ch, 1, 1),
        "encoder.pre_encode.conv.6.bias": t(ch),
    }
    freq = cfg.mel.n_mels
    for _ in range(3):
        freq = (freq + 2 + 1 - 3) // 2 + 1
    sd["encoder.pre_encode.out.weight"] = t(d, ch * freq)
    sd["encoder.pre_encode.out.bias"] = t(d)
    for l in range(cfg.num_layers):
        p = f"encoder.layers.{l}."
        sd.update({
            p + "norm_feed_forward1.weight": t(d), p + "norm_feed_forward1.bias": t(d),
            p + "feed_forward1.linear1.weight": t(f, d),
            p + "feed_forward1.linear2.weight": t(d, f),
            p + "norm_self_att.weight": t(d), p + "norm_self_att.bias": t(d),
            p + "self_attn.linear_q.weight": t(d, d),
            p + "self_attn.linear_k.weight": t(d, d),
            p + "self_attn.linear_v.weight": t(d, d),
            p + "self_attn.linear_out.weight": t(d, d),
            p + "self_attn.linear_pos.weight": t(d, d),
            p + "self_attn.pos_bias_u": t(cfg.num_heads, d // cfg.num_heads),
            p + "self_attn.pos_bias_v": t(cfg.num_heads, d // cfg.num_heads),
            p + "norm_conv.weight": t(d), p + "norm_conv.bias": t(d),
            p + "conv.pointwise_conv1.weight": t(2 * d, d, 1),
            p + "conv.depthwise_conv.weight": t(d, 1, cfg.conv_kernel),
            p + "conv.batch_norm.weight": t(d), p + "conv.batch_norm.bias": t(d),
            p + "conv.pointwise_conv2.weight": t(d, d, 1),
            p + "norm_feed_forward2.weight": t(d), p + "norm_feed_forward2.bias": t(d),
            p + "feed_forward2.linear1.weight": t(f, d),
            p + "feed_forward2.linear2.weight": t(d, f),
            p + "norm_out.weight": t(d), p + "norm_out.bias": t(d),
        })
    ph = cfg.prompt_hidden
    sd["prompt_kernel.0.weight"] = t(ph, d + cfg.num_prompts)
    sd["prompt_kernel.0.bias"] = t(ph)
    sd["prompt_kernel.2.weight"] = t(ph, ph)
    sd["prompt_kernel.2.bias"] = t(ph)
    sd["joint.enc.weight"] = t(cfg.joint_hidden, ph)
    sd["joint.enc.bias"] = t(cfg.joint_hidden)
    sd["decoder.prediction.embed.weight"] = t(cfg.vocab_size + 1, cfg.pred_hidden)
    for li in range(cfg.lstm_layers):
        sd[f"decoder.prediction.dec_rnn.lstm.weight_ih_l{li}"] = t(4 * cfg.pred_hidden, cfg.pred_hidden)
        sd[f"decoder.prediction.dec_rnn.lstm.weight_hh_l{li}"] = t(4 * cfg.pred_hidden, cfg.pred_hidden)
        sd[f"decoder.prediction.dec_rnn.lstm.bias_ih_l{li}"] = t(4 * cfg.pred_hidden)
        sd[f"decoder.prediction.dec_rnn.lstm.bias_hh_l{li}"] = t(4 * cfg.pred_hidden)
    sd["joint.pred.weight"] = t(cfg.joint_hidden, cfg.pred_hidden)
    sd["joint.pred.bias"] = t(cfg.joint_hidden)
    sd["joint.joint_net.2.weight"] = t(cfg.vocab_size + 1, cfg.joint_hidden)
    sd["joint.joint_net.2.bias"] = t(cfg.vocab_size + 1)
    return sd


def _model_config(cfg):
    return {
        "preprocessor": {
            "sample_rate": cfg.sample_rate, "features": cfg.mel.n_mels,
            "n_fft": cfg.mel.n_fft,
            "window_size": cfg.mel.win_length / cfg.sample_rate,
            "window_stride": cfg.mel.hop_length / cfg.sample_rate,
        },
        "encoder": {
            "d_model": cfg.d_model, "n_layers": cfg.num_layers,
            "n_heads": cfg.num_heads, "ff_expansion_factor": cfg.ffn_dim / cfg.d_model,
            "conv_kernel_size": cfg.conv_kernel,
            "subsampling_factor": 8, "subsampling_conv_channels": cfg.sub_channels,
            "att_context_size": [[cfg.left_context, cfg.right_context], [6, 1]],
        },
        "decoder": {"vocab_size": cfg.vocab_size,
                    "prednet": {"pred_hidden": cfg.pred_hidden,
                                "pred_rnn_layers": cfg.lstm_layers}},
        "joint": {"num_classes": cfg.vocab_size,
                  "jointnet": {"joint_hidden": cfg.joint_hidden}},
        "model_defaults": {
            "num_prompts": cfg.num_prompts,
            "prompt_dictionary": {"auto": 0, "en-US": 1, "english": 1, "zh-CN": 2},
        },
        "decoding": {"greedy": {"max_symbols": cfg.max_symbols_per_frame}},
    }


def _write_nemo(tmp_path, cfg, sd):
    import io

    nemo = tmp_path / "model.nemo"
    with tarfile.open(nemo, "w") as tar:
        buf = io.BytesIO()
        torch.save(sd, buf)
        info = tarfile.TarInfo("model_weights.ckpt")
        info.size = buf.getbuffer().nbytes
        buf.seek(0)
        tar.addfile(info, buf)
        yml = yaml.safe_dump(_model_config(cfg)).encode()
        info = tarfile.TarInfo("model_config.yaml")
        info.size = len(yml)
        tar.addfile(info, io.BytesIO(yml))
        spm = _tiny_spm_proto([("<unk>", 0.0, 2)] + [(f"▁tok{i}", -float(i), 1)
                                                    for i in range(TINY.vocab_size)])
        info = tarfile.TarInfo("abc_tokenizer.model")
        info.size = len(spm)
        tar.addfile(info, io.BytesIO(spm))
    return nemo


def _tiny_spm_proto(pieces):
    """Hand-encode a minimal SentencePiece ModelProto (repeated field 1 =
    SentencePiece{piece: str=1, score: float=2, type: enum=3})."""
    import struct

    def varint(n):
        out = b""
        while True:
            b7 = n & 0x7F
            n >>= 7
            out += bytes([b7 | (0x80 if n else 0)])
            if not n:
                return out

    blob = b""
    for piece, score, ptype in pieces:
        pb = piece.encode("utf-8")
        sub = b"\x0a" + varint(len(pb)) + pb
        sub += b"\x15" + struct.pack("<f", score)
        sub += b"\x18" + varint(ptype)
        blob += b"\x0a" + varint(len(sub)) + sub
    return blob


def test_read_archive_and_config(tmp_path):
    from asr_jax.loaders import nemotron_nemo as nn

    rng = np.random.default_rng(0)
    sd_in = _nemotron_sd(TINY, rng)
    nemo = _write_nemo(tmp_path, TINY, sd_in)
    sd, cfg_yaml, assets = nn.read_nemo_archive(nemo, tmp_path / "x")
    assert set(sd) == set(sd_in)
    cfg = nn.config_from_model_config(cfg_yaml)  # offline: widest right
    assert (cfg.d_model, cfg.num_layers, cfg.vocab_size) == (TINY.d_model, TINY.num_layers, TINY.vocab_size)
    assert (cfg.left_context, cfg.right_context) == (TINY.left_context, TINY.right_context)
    # Streaming: closest chunk duration. frame = 8 * hop / sr * 1000 = 80 ms;
    # pair [6,1] -> chunk 160 ms, pair [l,3] -> 320 ms.
    scfg = nn.config_from_model_config(cfg_yaml, chunk_ms=150)
    assert (scfg.left_context, scfg.right_context) == (6, 1)


def test_mapping_prompt_collapse_exact(tmp_path):
    """The one-hot prompt fold must equal the original concat-GEMM."""
    from asr_jax.loaders import nemotron_nemo as nn

    rng = np.random.default_rng(1)
    sd = _nemotron_sd(TINY, rng)
    params = nn.nemotron_params_from_state_dict(sd, TINY)
    w0 = sd["prompt_kernel.0.weight"].numpy()
    b0 = sd["prompt_kernel.0.bias"].numpy()
    enc = rng.standard_normal((3, TINY.d_model)).astype(np.float32)
    for pid in (0, TINY.num_prompts - 1):
        onehot = np.zeros((TINY.num_prompts,), np.float32)
        onehot[pid] = 1.0
        ref = np.concatenate([enc, np.tile(onehot, (3, 1))], -1) @ w0.T + b0
        ours = enc @ np.asarray(params["prompt"]["w0_enc"]) + np.asarray(
            params["prompt"]["bias_table"])[pid]
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)

    # Mapped params drive the real jitted forward.
    audio = jnp.asarray((rng.standard_normal((1, 8000)) * 2000).astype(np.float32))
    tokens, counts = nm.forward(params, TINY, audio, jnp.asarray([8000], np.int32),
                                jnp.asarray([1], np.int32), max_tokens=16)
    assert tokens.shape[0] == 1 and int(counts[0]) >= 0


def test_builder_both_modes(tmp_path):
    from asr_jax import export as ex
    from asr_jax.cli import _build_session
    from asr_jax.runtime.metadata import ModelMetadata

    rng = np.random.default_rng(2)
    nemo = _write_nemo(tmp_path, TINY, _nemotron_sd(TINY, rng))
    out = ex.build_nemotron_artifact(nemo, tmp_path / "offline")
    meta = ModelMetadata.load(out)
    assert meta.family == "nemotron"
    assert meta.resolve_language("english").prompt_token_id == 1
    assert not (out / "model_weights.ckpt").exists()  # redundant ckpt dropped
    sess = _build_session(out, language="en-US")
    res = sess.transcribe((rng.standard_normal(4800) * 0.05).astype(np.float32))
    assert isinstance(res.text, str)

    out2 = ex.build_nemotron_artifact(nemo, tmp_path / "stream", streaming=True, chunk_ms=150)
    meta2 = ModelMetadata.load(out2)
    assert meta2.family == "nemotron_streaming"
    assert meta2.extra["config"]["right_context"] == 1


def test_dolphin_streaming_builder(tmp_path):
    """Dolphin CN-Dialect-Streaming shares the espnet module tree: the
    offline loader + streaming family stamp must round trip into a
    DolphinStreamingSession."""
    from asr_jax import export as ex
    from asr_jax.cli import _build_session
    from asr_jax.models import dolphin as dp
    from asr_jax.runtime.metadata import ModelMetadata
    from asr_jax.streaming.dolphin_stream import DolphinStreamConfig
    from tests.test_loaders import _dolphin_sd

    DTINY = dp.DolphinConfig(
        vocab_size=60, d_model=32, enc_layers=2, enc_heads=4, enc_ffn=48,
        cgmlp_dim=64, csgu_kernel=5, fusion_kernel=3, dec_layers=2, dec_heads=4,
        dec_ffn=48, sos_id=50, eos_id=51, max_target_positions=24,
    )
    rng = np.random.default_rng(3)
    sd = _dolphin_sd(DTINY, rng)
    ckpt = tmp_path / "model.pt"
    torch.save(sd, ckpt)
    scfg = DolphinStreamConfig(base=DTINY, chunk_frames=8, max_frames=64)
    out = ex.build_dolphin_artifact(ckpt, tmp_path / "artifact", cfg=scfg, streaming=True)
    meta = ModelMetadata.load(out)
    assert meta.family == "dolphin_streaming"
    assert meta.extra["config"]["chunk_frames"] == 8
    sess = _build_session(out)
    assert type(sess).__name__ == "DolphinStreamingSession"
