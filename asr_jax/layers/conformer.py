"""FastConformer encoder blocks (NeMo/Parakeet/Nemotron style), unfolded.

Block = half-step FFN -> rel-pos self-attention (Transformer-XL skew) ->
conv module (pointwise/GLU/depthwise/BatchNorm/SiLU/pointwise) -> half-step
FFN -> LayerNorm, with 2D-conv 8x subsampling in front (reference
``Parakeet/Export_Parakeet_ASR.py:254-470``; HF ``ParakeetEncoder`` is the
same math). The reference bakes LayerNorm affines / BatchNorm stats /
rel-pos projections into folded weights at export; here checkpoints stay
unfolded (BN running stats are reduced to a per-channel affine at load —
the one fold that is genuinely free) and XLA fuses the rest.

Padded-batch exactness: every conv input is zero-masked at padded frames
and attention carries a key-validity bias, so fixed-shape batches match
variable-length runs in the valid region.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from asr_jax.layers.norms import layer_norm
from asr_jax.layers.sanm import depthwise_conv1d_time
from asr_jax.layers.transformer import dense


def relative_position_embedding(seq_len: int, d_model: int) -> np.ndarray:
    """Interleaved sin/cos table over relative positions S-1 .. -(S-1),
    shape (2S-1, D) (reference ``Export_Parakeet_ASR.py:305-310``)."""
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, d_model, 2, dtype=np.float64) / d_model))
    positions = np.arange(seq_len - 1, -seq_len, -1, dtype=np.float64)
    freqs = positions[:, None] * inv_freq[None, :]
    emb = np.stack([np.sin(freqs), np.cos(freqs)], axis=-1).reshape(len(positions), d_model)
    return emb.astype(np.float32)


def rel_shift(x: jnp.ndarray) -> jnp.ndarray:
    """Transformer-XL skew: (B, H, S, 2S-1) -> (B, H, S, 2S-1) such that
    out[..., i, j] = x[..., i, j + S - 1 - i] (then caller slices [..., :S])."""
    b, h, s, w = x.shape
    x = jnp.pad(x, ((0, 0), (0, 0), (0, 0), (1, 0)))
    x = x.reshape(b, h, w + 1, s)
    x = x[:, :, 1:]
    return x.reshape(b, h, s, w)


def _ff(x: jnp.ndarray, p: dict) -> jnp.ndarray:
    return dense(jax.nn.silu(dense(x, p["w1"])), p["w2"])


def rel_pos_attention(
    x: jnp.ndarray,
    p: dict,
    num_heads: int,
    pos_embed: jnp.ndarray,
    attn_bias: jnp.ndarray | None,
) -> jnp.ndarray:
    """Relative-position MHA. x (B,S,D); pos_embed (2S-1, D)."""
    b, s, d = x.shape
    hd = d // num_heads
    q = dense(x, p["q"]).reshape(b, s, num_heads, hd).transpose(0, 2, 1, 3)
    k = dense(x, p["k"]).reshape(b, s, num_heads, hd).transpose(0, 2, 1, 3)
    v = dense(x, p["v"]).reshape(b, s, num_heads, hd).transpose(0, 2, 1, 3)
    rel_k = dense(pos_embed, p["rel_k"]).reshape(-1, num_heads, hd)  # (2S-1, H, hd)
    qu = q + p["bias_u"][None, :, None, :]
    qv = q + p["bias_v"][None, :, None, :]
    ac = jnp.einsum("bhsd,bhtd->bhst", qu, k)
    bd = jnp.einsum("bhsd,phd->bhsp", qv, rel_k)
    bd = rel_shift(bd)[..., :s]
    scores = (ac + bd).astype(jnp.float32) * (hd ** -0.5)
    if attn_bias is not None:
        scores = scores + attn_bias
    probs = jax.nn.softmax(scores, axis=-1).astype(x.dtype)
    ctx = jnp.einsum("bhst,bhtd->bshd", probs, v).reshape(b, s, d)
    return dense(ctx, p["o"])


def conv_module(x: jnp.ndarray, p: dict, key_mask: jnp.ndarray | None) -> jnp.ndarray:
    """Conformer conv module. x (B,S,D). BN folded to affine (scale, shift)."""
    y = dense(x, p["pw1"])  # (B,S,2D)
    a, g = jnp.split(y, 2, axis=-1)
    y = a * jax.nn.sigmoid(g)  # GLU
    if key_mask is not None:
        y = jnp.where(key_mask[..., None], y, 0)
    k = p["dw"]["w"].shape[0]
    pad = (k - 1) // 2
    y = depthwise_conv1d_time(y, p["dw"]["w"], pad, pad) + p["dw"]["b"]
    y = y * p["bn"]["scale"] + p["bn"]["shift"]
    y = jax.nn.silu(y)
    return dense(y, p["pw2"])


def conformer_block(
    x: jnp.ndarray,
    p: dict,
    num_heads: int,
    pos_embed: jnp.ndarray,
    attn_bias: jnp.ndarray | None,
    key_mask: jnp.ndarray | None,
) -> jnp.ndarray:
    x = x + 0.5 * _ff(layer_norm(x, p["norm_ff1"]["scale"], p["norm_ff1"]["bias"]), p["ff1"])
    y = layer_norm(x, p["norm_att"]["scale"], p["norm_att"]["bias"])
    x = x + rel_pos_attention(y, p["attn"], num_heads, pos_embed, attn_bias)
    y = layer_norm(x, p["norm_conv"]["scale"], p["norm_conv"]["bias"])
    x = x + conv_module(y, p["conv"], key_mask)
    x = x + 0.5 * _ff(layer_norm(x, p["norm_ff2"]["scale"], p["norm_ff2"]["bias"]), p["ff2"])
    return layer_norm(x, p["norm_out"]["scale"], p["norm_out"]["bias"])


def conv2d(x, w, b=None, stride=(1, 1), padding=(0, 0), groups=1):
    """NHWC conv2d; w is HWIO."""
    y = jax.lax.conv_general_dilated(
        x, w, stride, [(padding[0], padding[0]), (padding[1], padding[1])],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups,
    )
    if b is not None:
        y = y + b
    return y


def _conv_out_len(n, k, stride, pad):
    return (n + 2 * pad - k) // stride + 1


def subsample_conv2d(
    feats: jnp.ndarray, p: dict, valid: jnp.ndarray, kernel: int = 3, stride: int = 2
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """FastConformer dw-separable 8x subsampling.

    feats (B, T, n_mels) -> (B, T // 8, d_model); returns new valid lengths.
    Masks padded frames after every strided conv (HF parity).
    """
    pad = (kernel - 1) // 2
    x = feats[..., None]  # (B, T, M, 1) = NHWC with H=time, W=mel
    valid = jnp.asarray(valid, jnp.int32)

    def mask_time(x, valid):
        t = x.shape[1]
        keep = jnp.arange(t, dtype=jnp.int32)[None, :] < valid[:, None]
        return jnp.where(keep[:, :, None, None], x, 0)

    ch = p["conv0"]["w"].shape[-1]
    x = mask_time(x, valid)
    x = jax.nn.relu(conv2d(x, p["conv0"]["w"], p["conv0"]["b"], (stride, stride), (pad, pad)))
    valid = _conv_out_len(valid, kernel, stride, pad)
    for i in (1, 2):
        x = mask_time(x, valid)
        x = conv2d(x, p[f"dw{i}"]["w"], p[f"dw{i}"]["b"], (stride, stride), (pad, pad), groups=ch)
        valid = _conv_out_len(valid, kernel, stride, pad)
        x = jax.nn.relu(conv2d(x, p[f"pw{i}"]["w"], p[f"pw{i}"]["b"]))
    b, t = x.shape[0], x.shape[1]
    x = x.transpose(0, 1, 3, 2).reshape(b, t, -1)  # channels-major like torch flatten(2)
    return dense(x, p["out"]), valid
