"""icefall Zipformer2 loader: CompactRelPositionalEncoding formula
properties, chunk-scale edge corrections, causal+chunkwise conv fusion vs a
direct torch computation, and a full synthetic-state-dict load that drives
transcribe_chunk (reference baking: ``X-ASR/Export_X_ASR.py:282-376``)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from asr_jax.loaders import zipformer_icefall as zl
from asr_jax.models import zipformer as zf

TINY = zf.ZipformerConfig(
    vocab_size=40,
    downsampling_factor=(1, 2),
    num_encoder_layers=(1, 1),
    encoder_dim=(32, 48),
    query_head_dim=(8, 8),
    pos_head_dim=(4, 4),
    value_head_dim=(8, 8),
    num_heads=(2, 2),
    feedforward_dim=(48, 64),
    cnn_module_kernel=(7, 7),
    chunk_size=8,
    left_context_frames=16,
    sub_layer1=4, sub_layer2=8, sub_layer3=16,
    decoder_dim=16, joiner_dim=16, context_size=2, decoder_conv_groups=4,
)
POS_DIM = 48


def test_compact_rel_pos_encoding_properties():
    pe = zl.compact_rel_positional_encoding(np.arange(-5, 6), pos_dim=POS_DIM)
    assert pe.shape == (11, POS_DIM)
    # Position 0: atan(0)=0 -> cos cols 1, sin cols 0; last col is the bias 1.
    center = pe[5]
    np.testing.assert_allclose(center[0::2], 1.0, atol=1e-6)
    np.testing.assert_allclose(center[1:-1:2], 0.0, atol=1e-6)
    assert center[-1] == 1.0
    # Even/odd symmetry in the position: cosines even, sines odd.
    np.testing.assert_allclose(pe[2, 0::2], pe[8, 0::2], atol=1e-6)
    np.testing.assert_allclose(pe[2, 1:-1:2], -pe[8, 1:-1:2], atol=1e-6)
    # Compression: |atan| stays < pi/2 so all entries are bounded by 1.
    assert np.abs(pe).max() <= 1.0 + 1e-6
    # Unit slope near zero: pe for position 1 differs from position 0.
    assert np.abs(pe[6] - pe[5]).max() > 1e-3


def test_streaming_positions_length():
    seq, left = 8, 16
    pos = zl.streaming_positions(seq, left)
    assert len(pos) == 2 * seq - 1 + left
    assert pos[0] == -(seq + left - 1) and pos[-1] == seq - 1


def test_build_pos_table_matches_manual_projection():
    rng = np.random.default_rng(0)
    heads, phd, seq, left = 2, 4, 8, 16
    w = rng.standard_normal((heads * phd, POS_DIM)).astype(np.float32)
    table = zl.build_pos_table(w, seq, left, heads, phd)
    assert table.shape == (heads, phd, 2 * seq - 1 + left)
    pe = zl.compact_rel_positional_encoding(zl.streaming_positions(seq, left), POS_DIM)
    manual = (pe @ w.T).reshape(-1, heads, phd)
    np.testing.assert_allclose(table, manual.transpose(1, 2, 0), rtol=1e-5, atol=1e-6)


def test_chunk_scale_both_regimes():
    rng = np.random.default_rng(1)
    c, k = 3, 7
    param = rng.standard_normal((2, c, k)).astype(np.float32)
    # seq > kernel: zeros fill the middle
    s = zl.chunk_scale(param, 10)
    assert s.shape == (c, 10)
    expect = 1.0 + np.concatenate([param[0], np.zeros((c, 3), np.float32)], axis=1) \
        + np.concatenate([np.zeros((c, 3), np.float32), param[1]], axis=1)
    np.testing.assert_allclose(s, expect, rtol=1e-6)
    # seq < kernel: left edge takes first seq cols, right edge last seq cols
    s2 = zl.chunk_scale(param, 4)
    np.testing.assert_allclose(s2, 1.0 + param[0][:, :4] + param[1][:, -4:], rtol=1e-6)


def test_fuse_streaming_conv_matches_torch_pair():
    """Fused map == causal depthwise conv over [cache|chunk] + chunk-scaled
    chunkwise depthwise conv over the chunk alone."""
    import torch.nn.functional as F

    rng = np.random.default_rng(2)
    c, kernel, seq = 5, 7, 8
    left = kernel // 2
    causal_w = rng.standard_normal((c, left + 1)).astype(np.float32)
    causal_b = rng.standard_normal(c).astype(np.float32)
    chunk_w = rng.standard_normal((c, kernel)).astype(np.float32)
    chunk_b = rng.standard_normal(c).astype(np.float32)
    scale_param = (rng.standard_normal((2, c, kernel)) * 0.1).astype(np.float32)
    scale = zl.chunk_scale(scale_param, seq)

    fused_w, fused_b = zl.fuse_streaming_conv(causal_w, causal_b, chunk_w, chunk_b, scale)
    assert fused_w.shape == (c, seq, left + seq) and fused_b.shape == (c, seq)

    cache = rng.standard_normal((c, left)).astype(np.float32)
    chunk = rng.standard_normal((c, seq)).astype(np.float32)
    xfull = np.concatenate([cache, chunk], axis=1)  # (c, left+seq)

    # direct torch: causal over the padded window, chunkwise over the chunk
    t_x = torch.from_numpy(xfull)[None]
    t_causal = F.conv1d(t_x, torch.from_numpy(causal_w)[:, None],
                        torch.from_numpy(causal_b), groups=c)[0]  # (c, seq)
    t_chunkwise = F.conv1d(torch.from_numpy(chunk)[None],
                           torch.from_numpy(chunk_w)[:, None],
                           torch.from_numpy(chunk_b), padding=left, groups=c)[0]
    direct = t_causal.numpy() + t_chunkwise.numpy() * np.asarray(scale, np.float32)

    ours = np.einsum("ctk,kc->tc", fused_w, xfull.T) + fused_b.T  # (seq, c)
    np.testing.assert_allclose(ours.T, direct, rtol=1e-4, atol=1e-5)


def _synthetic_state_dict(cfg: zf.ZipformerConfig, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    sd = {}

    def add(key, *shape, scale=0.1):
        sd[key] = (rng.standard_normal(shape) * scale).astype(np.float32)

    l1, l2, l3 = cfg.sub_layer1, cfg.sub_layer2, cfg.sub_layer3
    out_width = (((cfg.feature_dim + 2 - 2) - 3) // 2 + 1 - 3) // 2 + 1
    e = "encoder_embed"
    add(f"{e}.conv.0.weight", l1, 1, 3, 3); add(f"{e}.conv.0.bias", l1)
    add(f"{e}.conv.4.weight", l2, l1, 3, 3); add(f"{e}.conv.4.bias", l2)
    add(f"{e}.conv.7.weight", l3, l2, 3, 3); add(f"{e}.conv.7.bias", l3)
    add(f"{e}.convnext.depthwise_conv.weight", l3, 1, 7, 7)
    add(f"{e}.convnext.depthwise_conv.bias", l3)
    add(f"{e}.convnext.pointwise_conv1.weight", 3 * l3, l3, 1, 1)
    add(f"{e}.convnext.pointwise_conv1.bias", 3 * l3)
    add(f"{e}.convnext.pointwise_conv2.weight", l3, 3 * l3, 1, 1)
    add(f"{e}.convnext.pointwise_conv2.bias", l3)
    add(f"{e}.out.weight", cfg.encoder_dim[0], l3 * out_width)
    add(f"{e}.out.bias", cfg.encoder_dim[0])
    add(f"{e}.out_norm.bias", cfg.encoder_dim[0])
    sd[f"{e}.out_norm.log_scale"] = np.float32(0.05)

    for s in range(cfg.num_stacks):
        g = cfg.stack_geom(s)
        d, h, qhd, phd, vhd = g["dim"], g["heads"], g["qhd"], g["phd"], g["vhd"]
        base = f"encoder.encoders.{s}"
        inner = base if g["ds"] == 1 else f"{base}.encoder"
        if g["ds"] != 1:
            add(f"{base}.downsample.bias", g["ds"])
            add(f"{base}.out_combiner.bypass_scale", d, scale=0.0)
            sd[f"{base}.out_combiner.bypass_scale"] += 0.5
        for l in range(cfg.num_encoder_layers[s]):
            p = f"{inner}.layers.{l}"
            add(f"{p}.self_attn_weights.in_proj.weight", 2 * h * qhd + h * phd, d)
            add(f"{p}.self_attn_weights.in_proj.bias", 2 * h * qhd + h * phd)
            add(f"{p}.self_attn_weights.linear_pos.weight", h * phd, POS_DIM)
            for n, fdim in (("1", g["ffn"] * 3 // 4), ("2", g["ffn"]), ("3", g["ffn"] * 5 // 4)):
                add(f"{p}.feed_forward{n}.in_proj.weight", fdim, d)
                add(f"{p}.feed_forward{n}.in_proj.bias", fdim)
                add(f"{p}.feed_forward{n}.out_proj.weight", d, fdim)
                add(f"{p}.feed_forward{n}.out_proj.bias", d)
            add(f"{p}.nonlin_attention.in_proj.weight", 3 * g["hidden"], d)
            add(f"{p}.nonlin_attention.in_proj.bias", 3 * g["hidden"])
            add(f"{p}.nonlin_attention.out_proj.weight", d, g["hidden"])
            add(f"{p}.nonlin_attention.out_proj.bias", d)
            for n in ("1", "2"):
                add(f"{p}.self_attn{n}.in_proj.weight", h * vhd, d)
                add(f"{p}.self_attn{n}.in_proj.bias", h * vhd)
                add(f"{p}.self_attn{n}.out_proj.weight", d, h * vhd)
                add(f"{p}.self_attn{n}.out_proj.bias", d)
            for n in ("1", "2"):
                cm = f"{p}.conv_module{n}"
                add(f"{cm}.in_proj.weight", 2 * d, d)
                add(f"{cm}.in_proj.bias", 2 * d)
                add(f"{cm}.depthwise_conv.causal_conv.weight", d, 1, g["kernel"] // 2 + 1)
                add(f"{cm}.depthwise_conv.causal_conv.bias", d)
                add(f"{cm}.depthwise_conv.chunkwise_conv.weight", d, 1, g["kernel"])
                add(f"{cm}.depthwise_conv.chunkwise_conv.bias", d)
                add(f"{cm}.depthwise_conv.chunkwise_conv_scale", 2, d, g["kernel"], scale=0.02)
                add(f"{cm}.out_proj.weight", d, d)
                add(f"{cm}.out_proj.bias", d)
            sd[f"{p}.bypass.bypass_scale"] = np.full(d, 0.5, np.float32)
            sd[f"{p}.bypass_mid.bypass_scale"] = np.full(d, 0.5, np.float32)
            add(f"{p}.norm.bias", d)
            sd[f"{p}.norm.log_scale"] = np.float32(0.02)

    add("encoder.downsample_output.bias", cfg.output_downsampling_factor)
    add("decoder.embedding.weight", cfg.vocab_size, cfg.decoder_dim)
    add("decoder.conv.weight", cfg.decoder_dim,
        cfg.decoder_dim // cfg.decoder_conv_groups, cfg.context_size)
    add("joiner.encoder_proj.weight", cfg.joiner_dim, cfg.output_dim)
    add("joiner.encoder_proj.bias", cfg.joiner_dim)
    add("joiner.decoder_proj.weight", cfg.joiner_dim, cfg.decoder_dim)
    add("joiner.decoder_proj.bias", cfg.joiner_dim)
    add("joiner.output_linear.weight", cfg.vocab_size, cfg.joiner_dim)
    add("joiner.output_linear.bias", cfg.vocab_size)
    return sd


def test_full_loader_structure_and_run():
    import chex

    sd = _synthetic_state_dict(TINY)
    params = zl.zipformer_params_from_state_dict(sd, TINY)
    ref = zf.init_params(TINY, jax.random.PRNGKey(0))
    chex.assert_trees_all_equal_shapes(params, ref)

    # loaded params drive a streaming chunk end to end
    state = zf.init_state(TINY)
    rng = np.random.default_rng(3)
    window = jnp.asarray((rng.standard_normal(TINY.window_samples) * 2000).astype(np.float32))
    state, ids, count = zf.transcribe_chunk(params, TINY, state, window)
    assert ids.shape[0] >= int(count) >= 0
    # linear weights transposed (torch (out,in) -> ours (in,out))
    np.testing.assert_allclose(
        np.asarray(params["encoder_proj"]["w"]),
        sd["joiner.encoder_proj.weight"].T, atol=1e-6)
