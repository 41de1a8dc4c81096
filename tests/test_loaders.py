"""Checkpoint loaders: FunASR name mapping on synthetic state dicts,
Kaldi mvn parsing, end-to-end forward through mapped params."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from asr_jax.loaders import funasr
from asr_jax.models import paraformer as pf
from asr_jax.models import sensevoice as sv

SV_CFG = sv.SenseVoiceConfig(
    vocab_size=64, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
    num_encoders0=1, num_encoders=2, num_tp_encoders=1, fsmn_kernel=5,
)


def _sanm_sd(prefix, in_size, hidden, ffn, kernel, rng):
    t = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32))
    return {
        f"{prefix}.norm1.weight": t(in_size), f"{prefix}.norm1.bias": t(in_size),
        f"{prefix}.self_attn.linear_q_k_v.weight": t(3 * hidden, in_size),
        f"{prefix}.self_attn.linear_q_k_v.bias": t(3 * hidden),
        f"{prefix}.self_attn.fsmn_block.weight": t(hidden, 1, kernel),
        f"{prefix}.self_attn.linear_out.weight": t(hidden, hidden),
        f"{prefix}.self_attn.linear_out.bias": t(hidden),
        f"{prefix}.norm2.weight": t(hidden), f"{prefix}.norm2.bias": t(hidden),
        f"{prefix}.feed_forward.w_1.weight": t(ffn, hidden),
        f"{prefix}.feed_forward.w_1.bias": t(ffn),
        f"{prefix}.feed_forward.w_2.weight": t(hidden, ffn),
        f"{prefix}.feed_forward.w_2.bias": t(hidden),
    }


def _sensevoice_sd(cfg, rng):
    sd = {}
    f = cfg.feature_size
    sd.update(_sanm_sd("encoder.encoders0.0", f, cfg.hidden, cfg.ffn_dim, cfg.fsmn_kernel, rng))
    for i in range(cfg.num_encoders):
        sd.update(_sanm_sd(f"encoder.encoders.{i}", cfg.hidden, cfg.hidden, cfg.ffn_dim, cfg.fsmn_kernel, rng))
    for i in range(cfg.num_tp_encoders):
        sd.update(_sanm_sd(f"encoder.tp_encoders.{i}", cfg.hidden, cfg.hidden, cfg.ffn_dim, cfg.fsmn_kernel, rng))
    t = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32))
    sd["encoder.after_norm.weight"] = t(cfg.hidden)
    sd["encoder.after_norm.bias"] = t(cfg.hidden)
    sd["encoder.tp_norm.weight"] = t(cfg.hidden)
    sd["encoder.tp_norm.bias"] = t(cfg.hidden)
    sd["ctc.ctc_lo.weight"] = t(cfg.vocab_size, cfg.hidden)
    sd["ctc.ctc_lo.bias"] = t(cfg.vocab_size)
    sd["embed.weight"] = t(16, f)
    return sd


def test_sensevoice_mapping_and_forward():
    rng = np.random.default_rng(0)
    cfg = SV_CFG
    sd = _sensevoice_sd(cfg, rng)
    neg_means = rng.standard_normal(cfg.feature_size).astype(np.float32)
    istd = np.abs(rng.standard_normal(cfg.feature_size)).astype(np.float32) + 0.5
    params = funasr.sensevoice_params_from_state_dict(sd, cfg, neg_means, istd)
    # weight orientation: qkv w is (in, 3*hidden)
    assert params["encoders"][0]["qkv"]["w"].shape == (cfg.hidden, 3 * cfg.hidden)
    assert params["encoders"][0]["fsmn_w"].shape == (cfg.fsmn_kernel, cfg.hidden)
    # sqrt(hidden) scale folded into cmvn + prompt rows
    np.testing.assert_allclose(
        np.asarray(params["cmvn_istd"]), istd * cfg.hidden ** 0.5, rtol=1e-6
    )
    lang_row0 = np.asarray(params["language_embed"][0])
    np.testing.assert_allclose(lang_row0, sd["embed.weight"][0].numpy() * cfg.hidden ** 0.5, rtol=1e-6)
    audio = jnp.asarray((rng.standard_normal((1, 4800)) * 2000).astype(np.float32))
    toks, counts = sv.forward(params, cfg, audio, jnp.asarray([4800]), jnp.asarray([1]))
    assert counts.shape == (1,)


PF_CFG = pf.ParaformerConfig(
    vocab_size=50, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
    num_encoders0=1, num_encoders=1, num_decoders=1, num_decoder_ffn=1,
    fsmn_kernel=5, predictor_kernel=3,
)


def _paraformer_sd(cfg, rng):
    sd = {}
    f = cfg.feature_size
    sd.update(_sanm_sd("encoder.encoders0.0", f, cfg.hidden, cfg.ffn_dim, cfg.fsmn_kernel, rng))
    sd.update(_sanm_sd("encoder.encoders.0", cfg.hidden, cfg.hidden, cfg.ffn_dim, cfg.fsmn_kernel, rng))
    t = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32))
    sd["encoder.after_norm.weight"] = t(cfg.hidden)
    sd["encoder.after_norm.bias"] = t(cfg.hidden)
    sd["predictor.cif_conv1d.weight"] = t(cfg.hidden, cfg.hidden, 3)
    sd["predictor.cif_conv1d.bias"] = t(cfg.hidden)
    sd["predictor.cif_output.weight"] = t(1, cfg.hidden)
    sd["predictor.cif_output.bias"] = t(1)
    pfx = "decoder.decoders.0"
    sd.update({
        f"{pfx}.norm1.weight": t(cfg.hidden), f"{pfx}.norm1.bias": t(cfg.hidden),
        f"{pfx}.feed_forward.w_1.weight": t(cfg.ffn_dim, cfg.hidden),
        f"{pfx}.feed_forward.w_1.bias": t(cfg.ffn_dim),
        f"{pfx}.feed_forward.norm.weight": t(cfg.ffn_dim),
        f"{pfx}.feed_forward.norm.bias": t(cfg.ffn_dim),
        f"{pfx}.feed_forward.w_2.weight": t(cfg.hidden, cfg.ffn_dim),
        f"{pfx}.feed_forward.w_2.bias": t(cfg.hidden),
        f"{pfx}.norm2.weight": t(cfg.hidden), f"{pfx}.norm2.bias": t(cfg.hidden),
        f"{pfx}.self_attn.fsmn_block.weight": t(cfg.hidden, 1, cfg.fsmn_kernel),
        f"{pfx}.norm3.weight": t(cfg.hidden), f"{pfx}.norm3.bias": t(cfg.hidden),
        f"{pfx}.src_attn.linear_q.weight": t(cfg.hidden, cfg.hidden),
        f"{pfx}.src_attn.linear_q.bias": t(cfg.hidden),
        f"{pfx}.src_attn.linear_k_v.weight": t(2 * cfg.hidden, cfg.hidden),
        f"{pfx}.src_attn.linear_k_v.bias": t(2 * cfg.hidden),
        f"{pfx}.src_attn.linear_out.weight": t(cfg.hidden, cfg.hidden),
        f"{pfx}.src_attn.linear_out.bias": t(cfg.hidden),
    })
    pfx3 = "decoder.decoders3.0"
    sd.update({
        f"{pfx3}.norm1.weight": t(cfg.hidden), f"{pfx3}.norm1.bias": t(cfg.hidden),
        f"{pfx3}.feed_forward.w_1.weight": t(cfg.ffn_dim, cfg.hidden),
        f"{pfx3}.feed_forward.w_1.bias": t(cfg.ffn_dim),
        f"{pfx3}.feed_forward.norm.weight": t(cfg.ffn_dim),
        f"{pfx3}.feed_forward.norm.bias": t(cfg.ffn_dim),
        f"{pfx3}.feed_forward.w_2.weight": t(cfg.hidden, cfg.ffn_dim),
        f"{pfx3}.feed_forward.w_2.bias": t(cfg.hidden),
    })
    sd["decoder.after_norm.weight"] = t(cfg.hidden)
    sd["decoder.after_norm.bias"] = t(cfg.hidden)
    sd["decoder.output_layer.weight"] = t(cfg.vocab_size, cfg.hidden)
    sd["decoder.output_layer.bias"] = t(cfg.vocab_size)
    return sd


def test_paraformer_mapping_and_forward():
    rng = np.random.default_rng(1)
    cfg = PF_CFG
    f = cfg.feature_size
    sd = _paraformer_sd(cfg, rng)
    neg_means = rng.standard_normal(f).astype(np.float32)
    istd = np.abs(rng.standard_normal(f)).astype(np.float32) + 0.5
    params = funasr.paraformer_params_from_state_dict(sd, cfg, neg_means, istd)
    audio = jnp.asarray((rng.standard_normal((1, 4800)) * 2000).astype(np.float32))
    ids, counts = pf.forward(params, cfg, audio, jnp.asarray([4800]), max_tokens=16)
    assert ids.shape == (1, 16)


def test_parse_kaldi_mvn(tmp_path):
    p = tmp_path / "am.mvn"
    p.write_text(
        "<Nnet>\n<Splice> 5 5\n[ 0 ]\n<AddShift> 3 3\n<LearnRateCoef> 0 [ -1.5 -2.5 -3.5 ]\n"
        "<Rescale> 3 3\n<LearnRateCoef> 0 [ 0.5 0.25 0.125 ]\n</Nnet>\n"
    )
    neg_means, istd = funasr.parse_kaldi_mvn(p)
    np.testing.assert_allclose(neg_means, [-1.5, -2.5, -3.5])
    np.testing.assert_allclose(istd, [0.5, 0.25, 0.125])


def _dolphin_sd(cfg, rng):
    """Synthetic espnet Dolphin state dict at cfg geometry (shared by the
    offline-mapping and streaming-builder tests)."""
    t = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32))
    d = cfg.d_model
    half = cfg.cgmlp_dim // 2
    ffn = cfg.enc_ffn
    sd = {}
    for li in range(cfg.enc_layers):
        p = f"encoder.encoders.{li}"
        for name, shape in [
            (f"{p}.norm_ff_macaron", (d,)), (f"{p}.norm_mha", (d,)), (f"{p}.norm_mlp", (d,)),
            (f"{p}.norm_ff", (d,)), (f"{p}.norm_final", (d,)), (f"{p}.cgmlp.csgu.norm", (half,)),
        ]:
            sd[f"{name}.weight"] = t(*shape)
            sd[f"{name}.bias"] = t(*shape)
        for name, (o, i) in [
            (f"{p}.feed_forward_macaron.w_1", (ffn, d)), (f"{p}.feed_forward_macaron.w_2", (d, ffn)),
            (f"{p}.feed_forward.w_1", (ffn, d)), (f"{p}.feed_forward.w_2", (d, ffn)),
            (f"{p}.attn.linear_q", (d, d)), (f"{p}.attn.linear_k", (d, d)),
            (f"{p}.attn.linear_v", (d, d)), (f"{p}.attn.linear_out", (d, d)),
            (f"{p}.cgmlp.channel_proj1.0", (cfg.cgmlp_dim, d)), (f"{p}.cgmlp.channel_proj2", (d, half)),
            (f"{p}.merge_proj", (d, 2 * d)),
        ]:
            sd[f"{name}.weight"] = t(o, i)
            sd[f"{name}.bias"] = t(o)
        sd[f"{p}.attn.linear_pos.weight"] = t(d, d)
        sd[f"{p}.attn.pos_bias_u"] = t(cfg.enc_heads, d // cfg.enc_heads)
        sd[f"{p}.attn.pos_bias_v"] = t(cfg.enc_heads, d // cfg.enc_heads)
        sd[f"{p}.cgmlp.csgu.conv.weight"] = t(half, 1, cfg.csgu_kernel)
        sd[f"{p}.cgmlp.csgu.conv.bias"] = t(half)
        sd[f"{p}.depthwise_conv_fusion.weight"] = t(2 * d, 1, cfg.fusion_kernel)
        sd[f"{p}.depthwise_conv_fusion.bias"] = t(2 * d)
    for li in range(cfg.dec_layers):
        q = f"decoder.decoders.{li}"
        for name, shape in [(f"{q}.norm1", (d,)), (f"{q}.norm2", (d,)), (f"{q}.norm3", (d,))]:
            sd[f"{name}.weight"] = t(*shape)
            sd[f"{name}.bias"] = t(*shape)
        for name, (o, i) in [
            (f"{q}.self_attn.linear_q", (d, d)), (f"{q}.self_attn.linear_k", (d, d)),
            (f"{q}.self_attn.linear_v", (d, d)), (f"{q}.self_attn.linear_out", (d, d)),
            (f"{q}.src_attn.linear_q", (d, d)), (f"{q}.src_attn.linear_k", (d, d)),
            (f"{q}.src_attn.linear_v", (d, d)), (f"{q}.src_attn.linear_out", (d, d)),
            (f"{q}.feed_forward.w_1", (cfg.dec_ffn, d)), (f"{q}.feed_forward.w_2", (d, cfg.dec_ffn)),
        ]:
            sd[f"{name}.weight"] = t(o, i)
            sd[f"{name}.bias"] = t(o)
    sd["encoder.global_cmvn.mean"] = t(80)
    sd["encoder.global_cmvn.std"] = torch.abs(t(80)) + 0.5
    sd["encoder.embed.conv.0.weight"] = t(d, 1, 3, 3)
    sd["encoder.embed.conv.0.bias"] = t(d)
    sd["encoder.embed.conv.2.weight"] = t(d, d, 3, 3)
    sd["encoder.embed.conv.2.bias"] = t(d)
    sub_freq = ((80 - 1) // 2 - 1) // 2
    sd["encoder.embed.out.0.weight"] = t(d, d * sub_freq)
    sd["encoder.embed.out.0.bias"] = t(d)
    sd["encoder.after_norm.weight"] = t(d)
    sd["encoder.after_norm.bias"] = t(d)
    sd["ctc.ctc_lo.weight"] = t(cfg.vocab_size, d)
    sd["ctc.ctc_lo.bias"] = t(cfg.vocab_size)
    sd["decoder.embed.0.weight"] = t(cfg.vocab_size, d)
    sd["decoder.after_norm.weight"] = t(d)
    sd["decoder.after_norm.bias"] = t(d)
    return sd


def test_dolphin_espnet_mapping(tmp_path):
    from asr_jax.loaders import dolphin_espnet
    from asr_jax.models import dolphin as dp

    cfg = dp.DolphinConfig(
        vocab_size=60, d_model=32, enc_layers=1, enc_heads=4, enc_ffn=48,
        cgmlp_dim=64, csgu_kernel=5, fusion_kernel=3, dec_layers=1, dec_heads=4,
        dec_ffn=48, sos_id=50, eos_id=51, max_target_positions=16,
    )
    rng = np.random.default_rng(7)
    sd = _dolphin_sd(cfg, rng)
    params = dolphin_espnet.params_from_state_dict(sd, cfg)
    audio = jnp.asarray((rng.standard_normal((1, 8000)) * 0.1).astype(np.float32))
    enc, valid = dp.encode(params, cfg, audio, jnp.asarray([8000]))
    assert enc.shape[-1] == cfg.d_model
    ids, counts = dp.ctc_decode(params, cfg, enc, valid)
    assert ids.shape[0] == 1


def test_funasr_config_derivation():
    """Geometry auto-derivation from checkpoint shapes (the reference's
    zh/en profile auto-detection analog, Export_Paraformer.py:41-59)."""
    rng = np.random.default_rng(3)
    cfg = SV_CFG
    sd = _sensevoice_sd(cfg, rng)
    got = funasr.sensevoice_config_from_state_dict(
        sd, num_heads=cfg.num_heads, head_dim=cfg.head_dim)
    assert (got.vocab_size, got.hidden, got.ffn_dim) == (cfg.vocab_size, cfg.hidden, cfg.ffn_dim)
    assert (got.num_encoders0, got.num_encoders, got.num_tp_encoders) == (
        cfg.num_encoders0, cfg.num_encoders, cfg.num_tp_encoders)
    assert got.fsmn_kernel == cfg.fsmn_kernel
