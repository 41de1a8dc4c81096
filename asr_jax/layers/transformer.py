"""Pre-LN transformer blocks (Whisper-style) with fixed-shape KV caches.

Covers the encoder block (self-attn + GELU MLP) and the decoder block
(causal self-attn with preallocated KV cache + cross-attn over cached
encoder KV + GELU MLP) used by Whisper/Dolphin/FireRedASR-style AR models
(reference ``Whisper/Export_Whisper.py:351-664``).

Static-shape cache design: caches are preallocated ``(B, T_max, H, D)``
buffers written with ``dynamic_update_slice`` at the current position,
and attention over the cache uses an additive validity mask — the
reference's concat-grow ONNX caches (dynamic axes) become fixed shapes
(SURVEY.md §7 "Growing KV caches").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from asr_jax.layers.attention import NEG_INF, mha
from asr_jax.layers.norms import layer_norm


def dense(x, p):
    w = p["w"]
    if not isinstance(w, jnp.ndarray) and "q" in w:
        if getattr(w, "dynamic", False):
            # Dynamic-activation INT8: per-row activation quant + int8
            # matmul (reference quantize_dynamic_int8 analog).
            from asr_jax.quant.quantize import dynamic_quant_dense

            y = dynamic_quant_dense(x, w)
        else:
            # Weight-only quantized leaf ({"q","scale","zero","bits","block"}):
            # XLA block dequant + matmul.
            from asr_jax.ops.quant_matmul import quant_dense

            y = quant_dense(x, w)
    else:
        y = jnp.dot(x, w)
    if "b" in p and p["b"] is not None:
        y = y + p["b"]
    return y


def split_heads(x: jnp.ndarray, num_heads: int) -> jnp.ndarray:
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads)


def merge_heads(x: jnp.ndarray) -> jnp.ndarray:
    b, t, h, d = x.shape
    return x.reshape(b, t, h * d)


def encoder_block(x: jnp.ndarray, p: dict, num_heads: int, attn_bias=None) -> jnp.ndarray:
    """Pre-LN self-attention block: x + attn(ln1(x)) then x + mlp(ln2(x))."""
    y = layer_norm(x, p["ln1"]["scale"], p["ln1"]["bias"])
    q = split_heads(dense(y, p["attn"]["q"]), num_heads)
    k = split_heads(dense(y, p["attn"]["k"]), num_heads)
    v = split_heads(dense(y, p["attn"]["v"]), num_heads)
    x = x + dense(merge_heads(mha(q, k, v, bias=attn_bias)), p["attn"]["o"])
    y = layer_norm(x, p["ln2"]["scale"], p["ln2"]["bias"])
    h = jax.nn.gelu(dense(y, p["mlp"]["fc1"]), approximate=False)
    return x + dense(h, p["mlp"]["fc2"])


def cross_kv(enc: jnp.ndarray, p: dict, num_heads: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Precompute per-layer cross-attention K/V from encoder output
    (computed once per utterance, like the reference's all-layer cross-KV
    export ``Whisper/Export_Whisper.py:395-420``)."""
    k = split_heads(dense(enc, p["cross"]["k"]), num_heads)
    v = split_heads(dense(enc, p["cross"]["v"]), num_heads)
    return k, v


def decoder_block(
    x: jnp.ndarray,
    p: dict,
    num_heads: int,
    self_k_cache: jnp.ndarray,
    self_v_cache: jnp.ndarray,
    pos: jnp.ndarray,
    cross_k: jnp.ndarray,
    cross_v: jnp.ndarray,
    cross_bias=None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Decoder block over ``x`` (B, S, D) written into the cache at ``pos``.

    ``self_k_cache``/``self_v_cache``: (B, T_max, H, Dh) preallocated.
    ``pos``: scalar int32 — index of x[:, 0] in the sequence.
    Causal masking: query i attends cache slots <= pos + i.
    Returns (out, new_k_cache, new_v_cache).
    """
    b, s, _ = x.shape
    t_max = self_k_cache.shape[1]
    y = layer_norm(x, p["ln1"]["scale"], p["ln1"]["bias"])
    q = split_heads(dense(y, p["attn"]["q"]), num_heads)
    k = split_heads(dense(y, p["attn"]["k"]), num_heads)
    v = split_heads(dense(y, p["attn"]["v"]), num_heads)
    self_k_cache = jax.lax.dynamic_update_slice(self_k_cache, k.astype(self_k_cache.dtype), (0, pos, 0, 0))
    self_v_cache = jax.lax.dynamic_update_slice(self_v_cache, v.astype(self_v_cache.dtype), (0, pos, 0, 0))
    slot = jnp.arange(t_max, dtype=jnp.int32)[None, :]  # (1, T_max)
    qpos = pos + jnp.arange(s, dtype=jnp.int32)[:, None]  # (S, 1)
    causal = jnp.where(slot <= qpos, 0.0, NEG_INF)[None, None].astype(jnp.float32)
    attn = mha(q, self_k_cache, self_v_cache, bias=causal)
    x = x + dense(merge_heads(attn), p["attn"]["o"])

    y = layer_norm(x, p["ln_cross"]["scale"], p["ln_cross"]["bias"])
    qc = split_heads(dense(y, p["cross"]["q"]), num_heads)
    xc = mha(qc, cross_k, cross_v, bias=cross_bias)
    x = x + dense(merge_heads(xc), p["cross"]["o"])

    y = layer_norm(x, p["ln2"]["scale"], p["ln2"]["bias"])
    h = jax.nn.gelu(dense(y, p["mlp"]["fc1"]), approximate=False)
    return x + dense(h, p["mlp"]["fc2"]), self_k_cache, self_v_cache
