"""Signal framing as shifted reshapes (no gathers).

The reference implements framing implicitly via ``Conv1d(stride=hop)``
(e.g. reference ``SenseVoice/Export_SenseVoice.py:136-154`` and
``Whisper/STFT_Process.py:136-150``). Here we instead materialize the
frame matrix ``(num_frames, padded_win)`` with a handful of static
reshape/slice ops and feed it to one large DFT **matmul**. No gather, no
conv, fully static shapes.

Trick: with ``K = ceil(win / hop)`` blocks of ``hop`` samples, frame ``m``
is ``blocks[m : m + K]`` flattened, of which the first ``win`` samples are
real and the tail is scratch that the (zero-padded) analysis basis ignores.
"""

from __future__ import annotations

import math

import jax.numpy as jnp


def num_frames_snip(num_samples: int, win: int, hop: int) -> int:
    """Kaldi ``snip_edges=True`` frame count: frames fully inside the signal."""
    if num_samples < win:
        return 0
    return (num_samples - win) // hop + 1


def frame_signal(x: jnp.ndarray, win: int, hop: int, n_frames: int) -> jnp.ndarray:
    """Extract ``n_frames`` overlapping frames of ``win`` samples at stride ``hop``.

    Args:
      x: ``(..., num_samples)`` waveform. ``num_samples`` must satisfy
        ``num_samples >= (n_frames - 1) * hop + win`` (caller pads).
      win: frame length in samples.
      hop: stride between frame starts.
      n_frames: static number of frames to emit.

    Returns:
      ``(..., n_frames, K * hop)`` where ``K = ceil(win / hop)``. Columns
      ``[0, win)`` hold the frame samples; columns ``[win, K * hop)`` are
      the samples that follow the frame (or padding) and must be ignored by
      multiplying against a basis that is zero there (see
      :func:`pad_basis_to_blocks`).
    """
    k = math.ceil(win / hop)
    need = (n_frames - 1 + k) * hop  # block m+k-1 must exist for the last frame
    pad = need - x.shape[-1]
    if pad > 0:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    elif pad < 0:
        x = x[..., :need]
    blocks = x.reshape(x.shape[:-1] + ((n_frames - 1 + k), hop))
    # Frame m = blocks[m : m + k] — k shifted static slices, then stack.
    parts = [blocks[..., i : i + n_frames, :] for i in range(k)]
    return jnp.concatenate(parts, axis=-1)


def pad_basis_to_blocks(basis: jnp.ndarray, win: int, hop: int) -> jnp.ndarray:
    """Zero-pad an analysis basis ``(win, F)`` to ``(K * hop, F)``.

    Frames produced by :func:`frame_signal` have ``K * hop`` columns of
    which only the first ``win`` are valid; padding the basis with zero
    rows makes the matmul ignore the scratch tail.
    """
    k = math.ceil(win / hop)
    pad = k * hop - win
    if pad == 0:
        return basis
    return jnp.pad(basis, ((0, pad), (0, 0)))
