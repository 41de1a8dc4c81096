"""CIF (Continuous Integrate-and-Fire) predictor decode, fixed-shape.

Reference semantics (``Paraformer/Non-Streaming/Export_Paraformer.py:
506-519`` / CifPredictorV2): per-frame weights ``alpha = sigmoid(...)``
accumulate; a token fires whenever the running sum crosses an integer
boundary; each fired token's acoustic embedding is the alpha-weighted sum
of encoder frames in its segment (the boundary frame's weight is split
between segments). A ``tail_threshold`` alpha is appended so a trailing
partial accumulation can still fire.

Numerics: FunASR accumulates alphas in float64 because an f32 cumsum "can
miss an integer boundary and change the transcript". Accelerators have
slow or no f64, so the alpha prefix-sum runs as a **compensated double-single scan**
(TwoSum via ``lax.scan``) with ~2^-48 effective precision, keeping x64
mode off (SURVEY.md §7 hard-parts).

Output is fixed-shape: ``(B, max_tokens, D)`` embeddings + valid counts,
via the same scatter-compaction trick as the CTC collapse.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def compensated_cumsum(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Cumulative sum with Kahan/Neumaier compensation along ``axis``.

    Sequential ``lax.scan`` over the axis (CIF alpha vectors are short —
    hundreds of frames — so the serial scan is negligible), error ~2^-48.
    """
    x = jnp.moveaxis(x.astype(jnp.float32), axis, 0)

    def body(carry, xi):
        s, c = carry
        t = s + xi
        # Neumaier two-sum error term.
        e = jnp.where(jnp.abs(s) >= jnp.abs(xi), (s - t) + xi, (xi - t) + s)
        c = c + e
        return (t, c), t + c

    (_, _), out = jax.lax.scan(body, (jnp.zeros_like(x[0]), jnp.zeros_like(x[0])), x)
    return jnp.moveaxis(out, 0, axis)


def cif_fire(
    alphas: jnp.ndarray,
    hidden: jnp.ndarray,
    valid_len: jnp.ndarray,
    max_tokens: int,
    tail_threshold: float = 0.45,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Integrate-and-fire.

    Args:
      alphas: ``(B, T)`` sigmoid weights (>= 0).
      hidden: ``(B, T, D)`` encoder outputs.
      valid_len: ``(B,)`` valid frame counts (padded frames are ignored).
      max_tokens: static output capacity.
      tail_threshold: virtual alpha appended after the last valid frame.

    Returns:
      embeds ``(B, max_tokens, D)`` fired acoustic embeddings (zero-padded),
      counts ``(B,)`` int32 fire counts.
    """
    b, t = alphas.shape
    d = hidden.shape[-1]
    pos = jnp.arange(t + 1, dtype=jnp.int32)[None, :]
    valid = jnp.asarray(valid_len, jnp.int32)[:, None]
    # Append the tail threshold AT the first padded slot; zero elsewhere.
    alphas_ext = jnp.concatenate([alphas, jnp.zeros((b, 1), alphas.dtype)], axis=1)
    alphas_ext = jnp.where(pos < valid, alphas_ext, 0.0)
    alphas_ext = jnp.where(pos == valid, tail_threshold, alphas_ext)
    hidden_ext = jnp.concatenate([hidden, jnp.zeros((b, 1, d), hidden.dtype)], axis=1)
    hidden_ext = jnp.where(pos[..., None] < valid[..., None], hidden_ext, 0.0)

    prefix = compensated_cumsum(alphas_ext, axis=1)  # (B, T+1)
    floor = jnp.floor(prefix)
    prev_floor = jnp.concatenate([jnp.zeros((b, 1), floor.dtype), floor[:, :-1]], axis=1)
    fire = floor > prev_floor  # (B, T+1)

    weighted = compensated_cumsum(
        (alphas_ext[..., None] * hidden_ext.astype(jnp.float32)).reshape(b, t + 1, d), axis=1
    )
    remains = prefix - floor
    # completed_prefix at fire j = weighted[j] - remains[j] * hidden[j]
    completed = weighted - remains[..., None] * hidden_ext.astype(jnp.float32)

    # Scatter fired rows (in order) into a (max_tokens + 1) buffer, then diff.
    dest = jnp.cumsum(fire.astype(jnp.int32), axis=1) - 1
    dest = jnp.where(fire, dest, max_tokens)  # dropped slot
    bidx = jnp.arange(b, dtype=jnp.int32)[:, None]
    buf = jnp.zeros((b, max_tokens + 1, d), jnp.float32)
    buf = buf.at[bidx, dest].set(completed, mode="drop")
    prev = jnp.concatenate([jnp.zeros((b, 1, d), jnp.float32), buf[:, : max_tokens - 1]], axis=1)
    counts = jnp.minimum(floor[:, -1].astype(jnp.int32), max_tokens)
    embeds = buf[:, :max_tokens] - prev
    tok_pos = jnp.arange(max_tokens, dtype=jnp.int32)[None, :]
    embeds = jnp.where(tok_pos[..., None] < counts[:, None, None], embeds, 0.0)
    return embeds, counts
