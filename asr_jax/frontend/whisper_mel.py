"""Whisper/librosa log-mel spectrogram as one matmul.

Matches OpenAI Whisper's ``log_mel_spectrogram`` (and HF
``WhisperFeatureExtractor``): center-reflect padded STFT with a periodic
Hann window, power spectrum, slaney-normalized mel bank, ``log10`` with a
1e-10 floor, per-sample dynamic-range clamp ``max(x, max - 8)`` and the
``(x + 4) / 4`` affine. The reference builds this as a Conv1d DFT
(``Whisper/STFT_Process.py:136-150,224-246`` + mel/log10/clamp at
``Whisper/Export_Whisper.py:424-427``); here the framed signal hits one
``(T, K*hop) @ (K*hop, 2*n_bins)`` DFT matmul.

Whisper drops the final STFT frame (``magnitudes[..., :-1]``) — handled by
emitting ``num_samples // hop`` frames (reference folds it into padding,
``Whisper/STFT_Process.py:96-101``).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from asr_jax.frontend import framing
from asr_jax.frontend.mel_banks import slaney_mel_banks


@dataclasses.dataclass(frozen=True)
class WhisperMelConfig:
    sample_rate: int = 16000
    n_mels: int = 128          # 128 for large-v3/turbo, 80 for v2 and earlier
    n_fft: int = 400
    hop_length: int = 160
    input_scale: float = 1.0   # 1/32768 if feeding int16-range samples

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        # center=True STFT gives 1 + n//hop frames; Whisper drops the last.
        return num_samples // self.hop_length


def hann_window_periodic(win: int) -> np.ndarray:
    n = np.arange(win, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win)).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _whisper_constants(cfg: WhisperMelConfig):
    window = hann_window_periodic(cfg.n_fft)
    freqs = np.arange(cfg.n_bins, dtype=np.float32)[:, None]
    samples = np.arange(cfg.n_fft, dtype=np.float32)[None, :]
    omega = (2.0 * np.pi / cfg.n_fft) * freqs * samples
    cos_basis = np.cos(omega, dtype=np.float32) * window
    sin_basis = -np.sin(omega, dtype=np.float32) * window
    kernel = np.concatenate([cos_basis, sin_basis], axis=0)  # (2*n_bins, n_fft)
    if cfg.input_scale != 1.0:
        kernel = kernel * np.float32(cfg.input_scale)
    k = -(-cfg.n_fft // cfg.hop_length)
    basis = np.zeros((k * cfg.hop_length, 2 * cfg.n_bins), dtype=np.float32)
    basis[: cfg.n_fft] = kernel.T
    mel = slaney_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sample_rate)
    return basis, mel


def log_mel_spectrogram(audio: jnp.ndarray, cfg: WhisperMelConfig) -> jnp.ndarray:
    """Whisper log-mel features.

    Args:
      audio: ``(..., num_samples)`` waveform in [-1, 1] (or via input_scale).

    Returns:
      ``(..., n_frames, n_mels)`` float32, ``n_frames = num_samples // hop``.
    """
    basis_np, mel_np = _whisper_constants(cfg)
    basis, mel = jnp.asarray(basis_np), jnp.asarray(mel_np)
    pad = cfg.n_fft // 2
    x = audio.astype(jnp.float32)
    x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    n_frames = cfg.num_frames(audio.shape[-1])
    frames = framing.frame_signal(x, cfg.n_fft, cfg.hop_length, n_frames)
    spectrum = jnp.dot(frames, basis, precision=jax.lax.Precision.HIGHEST)
    re, im = jnp.split(spectrum * spectrum, 2, axis=-1)
    power = re + im
    mel_feat = jnp.dot(power, mel, precision=jax.lax.Precision.HIGHEST)
    log_spec = jnp.log10(jnp.maximum(mel_feat, 1e-10))
    # Per-sample dynamic range clamp over (frames, mels).
    max_val = jnp.max(log_spec, axis=(-2, -1), keepdims=True)
    log_spec = jnp.maximum(log_spec, max_val - 8.0)
    return (log_spec + 4.0) / 4.0
