"""CTC greedy decode: argmax + repeat/blank collapse, fixed-shape on device.

Reference semantics (``SenseVoice/Export_SenseVoice.py:289-296``): argmax
per frame, drop consecutive repeats and blanks, emit the compact id list
plus its count. ONNX uses data-dependent NonZero/Gather; under jit we keep a
**fixed shape**: the compacted ids are scattered into a padded ``(B, T)``
buffer with a valid-count scalar per sample (the reference's ``num_id``
pattern, SURVEY.md §7 "dynamic shapes").
"""

from __future__ import annotations

import jax.numpy as jnp


def ctc_greedy_collapse(
    ids: jnp.ndarray, valid_len: jnp.ndarray, blank_id: int, pad_id: int = 0
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Collapse framewise argmax ids.

    Args:
      ids: ``(B, T)`` int32 framewise argmax token ids.
      valid_len: ``(B,)`` valid frame counts.
      blank_id: CTC blank.
      pad_id: filler for unused output slots.

    Returns:
      tokens ``(B, T)`` int32 left-compacted, counts ``(B,)`` int32.
    """
    b, t = ids.shape
    pos = jnp.arange(t, dtype=jnp.int32)[None, :]
    valid = pos < valid_len[:, None]
    prev = jnp.concatenate([jnp.full((b, 1), -1, ids.dtype), ids[:, :-1]], axis=1)
    keep = valid & (ids != blank_id) & (ids != prev)
    # Left-compact via scatter: destination slot = exclusive cumsum of keep.
    dest = jnp.cumsum(keep.astype(jnp.int32), axis=1) - 1
    dest = jnp.where(keep, dest, t)  # dropped ids land in an overflow slot
    out = jnp.full((b, t + 1), pad_id, dtype=jnp.int32)
    bidx = jnp.arange(b, dtype=jnp.int32)[:, None]
    out = out.at[bidx, dest].set(ids.astype(jnp.int32), mode="drop")
    counts = jnp.sum(keep, axis=1).astype(jnp.int32)
    return out[:, :t], counts
