"""General STFT / ISTFT utilities (the reference's ``STFT_Process`` family).

The reference exports five variants (``Whisper/STFT_Process.py:54-272``):
``stft_A`` (real+imag), ``stft_B`` (real+imag with center padding modes),
``stft_B_power`` (power spectrum), ``istft_A``/``istft_B`` (ConvTranspose
overlap-add with dynamic COLA normalization). Here STFT is the framed
matmul used by all front-ends, and ISTFT is an overlap-add with
window-sum normalization — both fixed-shape and jit-friendly.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from asr_jax.frontend import framing


def _window(kind: str, win: int, periodic: bool = True) -> np.ndarray:
    n = np.arange(win, dtype=np.float64)
    denom = win if periodic else win - 1
    if kind == "hann":
        return (0.5 - 0.5 * np.cos(2 * np.pi * n / denom)).astype(np.float32)
    if kind == "hamming":
        return (0.54 - 0.46 * np.cos(2 * np.pi * n / denom)).astype(np.float32)
    if kind == "povey":
        return ((0.5 - 0.5 * np.cos(2 * np.pi * n / denom)) ** 0.85).astype(np.float32)
    if kind in ("rect", "ones"):
        return np.ones(win, np.float32)
    raise ValueError(f"unknown window {kind!r}")


@functools.lru_cache(maxsize=16)
def _stft_consts(n_fft: int, win_length: int, window: str, periodic: bool):
    pad_l = (n_fft - win_length) // 2
    w = np.zeros(n_fft, np.float32)
    w[pad_l : pad_l + win_length] = _window(window, win_length, periodic)
    n_bins = n_fft // 2 + 1
    freqs = np.arange(n_bins, dtype=np.float32)[:, None]
    samples = np.arange(n_fft, dtype=np.float32)[None, :]
    omega = (2.0 * np.pi / n_fft) * freqs * samples
    basis = np.concatenate(
        [np.cos(omega, dtype=np.float32) * w, -np.sin(omega, dtype=np.float32) * w], axis=0
    ).T  # (n_fft, 2*n_bins)
    return basis, w


def stft(
    audio: jnp.ndarray,
    n_fft: int = 400,
    hop_length: int = 160,
    win_length: int | None = None,
    window: str = "hann",
    center: bool = True,
    pad_mode: str = "reflect",
    periodic: bool = True,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """STFT -> (real (..., T, n_bins), imag (..., T, n_bins))."""
    win_length = win_length or n_fft
    basis_np, _ = _stft_consts(n_fft, win_length, window, periodic)
    k = math.ceil(n_fft / hop_length)
    basis = jnp.asarray(np.pad(basis_np, ((0, k * hop_length - n_fft), (0, 0))))
    x = audio.astype(jnp.float32)
    if center:
        pad = n_fft // 2
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)],
                    mode=pad_mode if pad_mode != "zeros" else "constant")
        n_frames = audio.shape[-1] // hop_length + 1
    else:
        n_frames = framing.num_frames_snip(audio.shape[-1], n_fft, hop_length)
    frames = framing.frame_signal(x, n_fft, hop_length, n_frames)
    spec = jnp.dot(frames, basis, precision=jax.lax.Precision.HIGHEST)
    re, im = jnp.split(spec, 2, axis=-1)
    return re, im


def istft(
    real: jnp.ndarray,
    imag: jnp.ndarray,
    n_fft: int = 400,
    hop_length: int = 160,
    win_length: int | None = None,
    window: str = "hann",
    center: bool = True,
    length: int | None = None,
    periodic: bool = True,
) -> jnp.ndarray:
    """Inverse STFT via overlap-add with COLA (window-sum) normalization.

    real/imag: (..., T, n_bins). Returns (..., samples)."""
    win_length = win_length or n_fft
    _, w_np = _stft_consts(n_fft, win_length, window, periodic)
    n_bins = n_fft // 2 + 1
    # Inverse real-DFT basis: x[n] = (1/N) * sum_k c_k (re_k cos + im_k(-sin))
    n = np.arange(n_fft, dtype=np.float32)[None, :]
    k = np.arange(n_bins, dtype=np.float32)[:, None]
    omega = (2.0 * np.pi / n_fft) * k * n
    coef = np.full((n_bins, 1), 2.0, np.float32)
    coef[0] = 1.0
    if n_fft % 2 == 0:
        coef[-1] = 1.0
    inv_basis = np.concatenate(
        [np.cos(omega) * coef, -np.sin(omega) * coef], axis=0
    ).astype(np.float32) / n_fft  # (2*n_bins, n_fft)
    spec = jnp.concatenate([real, imag], axis=-1).astype(jnp.float32)
    frames = jnp.dot(spec, jnp.asarray(inv_basis), precision=jax.lax.Precision.HIGHEST)
    w = jnp.asarray(w_np)
    frames = frames * w  # synthesis window

    t = frames.shape[-2]
    out_len = n_fft + (t - 1) * hop_length
    batch_shape = frames.shape[:-2]
    flat = frames.reshape((-1, t, n_fft))

    # Overlap-add via scatter-add on frame start offsets.
    idx = (jnp.arange(t)[:, None] * hop_length + jnp.arange(n_fft)[None, :]).reshape(-1)
    sig = jnp.zeros((flat.shape[0], out_len), jnp.float32)
    sig = sig.at[:, idx].add(flat.reshape(flat.shape[0], -1))
    wsum = jnp.zeros((out_len,), jnp.float32).at[idx].add(
        jnp.broadcast_to(jnp.square(w), (t, n_fft)).reshape(-1)
    )
    sig = sig / jnp.maximum(wsum, 1e-8)[None, :]
    if center:
        pad = n_fft // 2
        sig = sig[:, pad : out_len - pad]
    if length is not None:
        sig = sig[:, :length]
    return sig.reshape(batch_shape + (sig.shape[-1],))


def power_spectrum(real: jnp.ndarray, imag: jnp.ndarray) -> jnp.ndarray:
    """``stft_B_power`` equivalent."""
    return jnp.square(real) + jnp.square(imag)
