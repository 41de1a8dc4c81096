"""SANM encoder block (FunASR): self-attention + FSMN memory + FFN.

This is the original (unfolded) SANM math — reference
``SenseVoice/Export_SenseVoice.py:227-258`` computes the same function
after export-time folds (q/k scale split, FSMN center-tap += 1,
linear_out bias moved onto the conv); we keep checkpoints unfolded and let
XLA fuse (SURVEY.md §7.2):

    y   = norm1(x)
    q,k,v = split(W_qkv y + b_qkv)
    ctx = softmax(q kᵀ / sqrt(d)) v
    mem = depthwise_conv(v, k_taps, symmetric zero pad) + v     # FSMN
    branch = W_out ctx + b_out + mem
    a   = branch + x            (only when in_size == out_size)
    out = a + W2 relu(W1 norm2(a) + b1) + b2

The depthwise FSMN conv is expressed as K shifted adds (elementwise,
no conv lowering). Padded batches: ``v`` is zero-masked past the valid
length so the conv sees the same zero padding a variable-length run would.
"""

from __future__ import annotations

import jax.numpy as jnp

from asr_jax.layers.attention import mha
from asr_jax.layers.norms import layer_norm


def depthwise_conv1d_time(x: jnp.ndarray, weight: jnp.ndarray, left_pad: int, right_pad: int) -> jnp.ndarray:
    """Depthwise conv over time as shifted adds.

    Args:
      x: ``(B, T, C)``.
      weight: ``(K, C)`` per-channel taps (tap 0 is the leftmost / most
        past-facing after left_pad padding).
    Returns ``(B, T + left_pad + right_pad - K + 1, C)`` — with symmetric
    pads ``(K-1)//2`` this is ``(B, T, C)``.
    """
    k = weight.shape[0]
    xp = jnp.pad(x, ((0, 0), (left_pad, right_pad), (0, 0)))
    t_out = xp.shape[1] - k + 1
    out = xp[:, 0:t_out, :] * weight[0]
    for i in range(1, k):
        out = out + xp[:, i : i + t_out, :] * weight[i]
    return out


def sanm_block(
    x: jnp.ndarray,
    p: dict,
    num_heads: int,
    head_dim: int,
    attn_bias: jnp.ndarray | None,
    key_mask: jnp.ndarray | None,
    residual: bool,
) -> jnp.ndarray:
    """One SANM block. ``x``: (B, T, in_size); returns (B, T, hidden).

    ``p`` keys: norm1{scale,bias}, qkv{w,b}, fsmn_w (K, hidden),
    out{w,b}, norm2{scale,bias}, ffn{w1,b1,w2,b2}.
    ``key_mask``: (B, T) bool validity; zero-masks v for FSMN + attention.
    """
    from asr_jax.layers.transformer import dense

    hidden = num_heads * head_dim
    y = layer_norm(x, p["norm1"]["scale"], p["norm1"]["bias"])
    qkv = dense(y, p["qkv"])
    q, k, v = jnp.split(qkv, 3, axis=-1)
    if key_mask is not None:
        v = jnp.where(key_mask[..., None], v, 0)
    b, t = x.shape[0], x.shape[1]
    ctx = mha(
        q.reshape(b, t, num_heads, head_dim),
        k.reshape(b, t, num_heads, head_dim),
        v.reshape(b, t, num_heads, head_dim),
        bias=attn_bias,
    ).reshape(b, t, hidden)
    pad = (p["fsmn_w"].shape[0] - 1) // 2
    mem = depthwise_conv1d_time(v, p["fsmn_w"], pad, pad) + v
    branch = dense(ctx, p["out"]) + mem
    a = branch + x if residual else branch
    y2 = layer_norm(a, p["norm2"]["scale"], p["norm2"]["bias"])
    h = jnp.maximum(dense(y2, {"w": p["ffn"]["w1"], "b": p["ffn"]["b1"]}), 0)
    return a + dense(h, {"w": p["ffn"]["w2"], "b": p["ffn"]["b2"]})
