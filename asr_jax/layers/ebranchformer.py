"""E-Branchformer encoder block (espnet): attention branch + cgMLP branch.

Used by Dolphin v1 / CN-Dialect and the Dolphin streaming encoder
(reference ``Dolphin/v1/Export_Dolphin.py:654-712`` shows the folded
forward; this is the unfolded checkpoint math):

    x  = x + 0.5 * ffn_macaron(norm_ff_macaron(x))
    a  = rel_pos_attention(norm_mha(x)) -> linear_out          # branch 1
    g0 = gelu(channel_proj1(norm_mlp(x)))                      # branch 2
    r, g = split(g0);  g = depthwise_conv(LayerNorm(g))        # CSGU
    m  = channel_proj2(r * g)
    c  = concat(a, m); c = depthwise_conv_fusion(c) + c        # merge conv
    x  = x + merge_proj(c)
    x  = x + 0.5 * ffn(norm_ff(x))
    x  = norm_final(x)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from asr_jax.layers.conformer import rel_pos_attention
from asr_jax.layers.norms import layer_norm
from asr_jax.layers.sanm import depthwise_conv1d_time
from asr_jax.layers.transformer import dense


def _ffn(x, p):
    y = layer_norm(x, p["norm"]["scale"], p["norm"]["bias"])
    return dense(jax.nn.silu(dense(y, p["w1"])), p["w2"])


def csgu(x: jnp.ndarray, p: dict, key_mask) -> jnp.ndarray:
    """Convolutional Spatial Gating Unit: split -> LN -> depthwise conv ->
    gate. x (B, T, 2*Dg) -> (B, T, Dg)."""
    r, g = jnp.split(x, 2, axis=-1)
    g = layer_norm(g, p["norm"]["scale"], p["norm"]["bias"])
    if key_mask is not None:
        g = jnp.where(key_mask[..., None], g, 0)
    k = p["conv"]["w"].shape[0]
    pad = (k - 1) // 2
    g = depthwise_conv1d_time(g, p["conv"]["w"], pad, pad)
    if "b" in p["conv"]:
        g = g + p["conv"]["b"]
    return r * g


def ebranchformer_block(
    x: jnp.ndarray,
    p: dict,
    num_heads: int,
    pos_embed: jnp.ndarray,
    attn_bias,
    key_mask,
) -> jnp.ndarray:
    x = x + 0.5 * _ffn(x, p["ffn_macaron"])
    y_att = layer_norm(x, p["norm_mha"]["scale"], p["norm_mha"]["bias"])
    x1 = rel_pos_attention(y_att, p["attn"], num_heads, pos_embed, attn_bias)
    y_mlp = layer_norm(x, p["norm_mlp"]["scale"], p["norm_mlp"]["bias"])
    g0 = jax.nn.gelu(dense(y_mlp, p["cgmlp"]["proj1"]), approximate=False)
    x2 = dense(csgu(g0, p["cgmlp"]["csgu"], key_mask), p["cgmlp"]["proj2"])
    c = jnp.concatenate([x1, x2], axis=-1)
    if key_mask is not None:
        c = jnp.where(key_mask[..., None], c, 0)
    k = p["fusion"]["w"].shape[0]
    pad = (k - 1) // 2
    fused = depthwise_conv1d_time(c, p["fusion"]["w"], pad, pad)
    if "b" in p["fusion"]:
        fused = fused + p["fusion"]["b"]
    c = c + fused
    x = x + dense(c, p["merge_proj"])
    x = x + 0.5 * _ffn(x, p["ffn"])
    return layer_norm(x, p["norm_final"]["scale"], p["norm_final"]["bias"])


def init_block_params(rng, d, heads, ffn_dim, cgmlp_dim, csgu_kernel, fusion_kernel, dtype=jnp.float32):
    keys = iter(jax.random.split(rng, 64))

    def lin(i, o, bias=True):
        p = {"w": (jax.random.normal(next(keys), (i, o)) * (i ** -0.5)).astype(dtype)}
        if bias:
            p["b"] = jnp.zeros((o,), dtype)
        return p

    def norm(dd=d):
        return {"scale": jnp.ones((dd,), dtype), "bias": jnp.zeros((dd,), dtype)}

    half = cgmlp_dim // 2
    return {
        "ffn_macaron": {"norm": norm(), "w1": lin(d, ffn_dim), "w2": lin(ffn_dim, d)},
        "norm_mha": norm(),
        "attn": {
            "q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d),
            "rel_k": {"w": (jax.random.normal(next(keys), (d, d)) * (d ** -0.5)).astype(dtype)},
            "bias_u": jnp.zeros((heads, d // heads), dtype),
            "bias_v": jnp.zeros((heads, d // heads), dtype),
        },
        "norm_mlp": norm(),
        "cgmlp": {
            "proj1": lin(d, cgmlp_dim),
            "csgu": {
                "norm": norm(half),
                "conv": {"w": (jax.random.normal(next(keys), (csgu_kernel, half)) * 0.1).astype(dtype),
                         "b": jnp.zeros((half,), dtype)},
            },
            "proj2": lin(half, d),
        },
        "fusion": {"w": (jax.random.normal(next(keys), (fusion_kernel, 2 * d)) * 0.1).astype(dtype),
                   "b": jnp.zeros((2 * d,), dtype)},
        "merge_proj": lin(2 * d, d),
        "ffn": {"norm": norm(), "w1": lin(d, ffn_dim), "w2": lin(ffn_dim, d)},
        "norm_final": norm(),
    }
