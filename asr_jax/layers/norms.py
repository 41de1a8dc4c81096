"""Normalization layers. Statistics always in float32 (safe under bf16)."""

from __future__ import annotations

import jax.numpy as jnp


def layer_norm(x: jnp.ndarray, scale: jnp.ndarray, bias: jnp.ndarray, eps: float = 1e-5) -> jnp.ndarray:
    """Standard affine LayerNorm over the last axis, computed in f32.

    Reference equivalent: ``torch.nn.functional.layer_norm`` as used by every
    family (e.g. ``SenseVoice/Export_SenseVoice.py:222-224``).
    """
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=-1, keepdims=True)
    y = (xf - mean) / jnp.sqrt(var + eps)
    y = y * scale.astype(jnp.float32) + bias.astype(jnp.float32)
    return y.astype(x.dtype)


def rms_norm(x: jnp.ndarray, scale: jnp.ndarray, eps: float = 1e-6) -> jnp.ndarray:
    """RMSNorm (Qwen3 'SimplifiedLayerNormalization', reference
    ``Qwen_ASR/Export_Qwen_ASR.py:1042-1074``)."""
    xf = x.astype(jnp.float32)
    var = jnp.mean(jnp.square(xf), axis=-1, keepdims=True)
    y = xf / jnp.sqrt(var + eps) * scale.astype(jnp.float32)
    return y.astype(x.dtype)
