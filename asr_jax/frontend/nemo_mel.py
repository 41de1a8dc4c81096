"""NeMo-convention log-mel front-end (Parakeet / Nemotron FastConformer).

Pipeline (reference ``Parakeet/Export_Parakeet_ASR.py:259-310,379-396``):
pre-emphasis ``x[t] - c*x[t-1]`` (zero boundary), STFT with a **symmetric**
Hann window zero-padded from win_length to n_fft and **constant** center
padding of n_fft//2, power spectrum, slaney mel (fmin 0, fmax sr/2),
``log(max(mel, 2^-24))``, drop the trailing frame, then **per-feature
normalization** over valid frames (mean/std with N-1 denominator, eps on
std). Same framed-matmul formulation as the other front-ends; the
per-feature norm is mask-aware so padded batches match exact-length runs.
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
class NemoMelConfig:
    sample_rate: int = 16000
    n_mels: int = 128
    n_fft: int = 512
    win_length: int = 400
    hop_length: int = 160
    preemphasis: float = 0.97
    log_guard: float = 2.0 ** -24
    norm_eps: float = 1e-5
    input_scale: float = 1.0  # 1/32768 for int16-range input

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        # center=True gives 1 + n//hop; NeMo drops the trailing frame.
        return num_samples // self.hop_length

    def valid_frames(self, valid_samples: jnp.ndarray) -> jnp.ndarray:
        return (jnp.asarray(valid_samples, jnp.int32) // self.hop_length).astype(jnp.int32)


def hann_window_symmetric(win: int) -> np.ndarray:
    n = np.arange(win, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / (win - 1))).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _nemo_constants(cfg: NemoMelConfig):
    pad_total = cfg.n_fft - cfg.win_length
    pad_l = pad_total // 2
    win = np.zeros(cfg.n_fft, np.float32)
    win[pad_l : pad_l + cfg.win_length] = hann_window_symmetric(cfg.win_length)
    freqs = np.arange(cfg.n_bins, dtype=np.float32)[:, None]
    samples = np.arange(cfg.n_fft, dtype=np.float32)[None, :]
    omega = (2.0 * np.pi / cfg.n_fft) * freqs * samples
    cos_b = np.cos(omega, dtype=np.float32) * win
    sin_b = -np.sin(omega, dtype=np.float32) * win
    kernel = np.concatenate([cos_b, sin_b], axis=0)
    k = -(-cfg.n_fft // cfg.hop_length)
    basis = np.zeros((k * cfg.hop_length, 2 * cfg.n_bins), np.float32)
    basis[: cfg.n_fft] = kernel.T
    mel = slaney_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sample_rate)
    return basis, mel


def log_mel(audio: jnp.ndarray, cfg: NemoMelConfig) -> jnp.ndarray:
    """(..., S) waveform -> (..., S // hop, n_mels) un-normalized log-mel."""
    basis_np, mel_np = _nemo_constants(cfg)
    basis, mel = jnp.asarray(basis_np), jnp.asarray(mel_np)
    x = audio.astype(jnp.float32) * cfg.input_scale
    prev = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(1, 0)])[..., :-1]
    x = x - cfg.preemphasis * prev
    pad = cfg.n_fft // 2
    x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)])  # constant zeros
    n_frames = cfg.num_frames(audio.shape[-1])
    frames = framing.frame_signal(x, cfg.n_fft, cfg.hop_length, n_frames)
    spec = jnp.dot(frames, basis, precision=jax.lax.Precision.HIGHEST)
    re, im = jnp.split(spec * spec, 2, axis=-1)
    power = re + im
    melspec = jnp.dot(power, mel, precision=jax.lax.Precision.HIGHEST)
    return jnp.log(jnp.maximum(melspec, cfg.log_guard))


def per_feature_norm(feats: jnp.ndarray, valid: jnp.ndarray, eps: float = 1e-5) -> jnp.ndarray:
    """NeMo per-feature normalization over the valid time range.

    feats (B, T, M); valid (B,). mean over valid frames; var with (N-1);
    normalized = (x - mean) / (std + eps). Padded frames produce zeros'
    stats contribution and are zeroed in the output.
    """
    t = feats.shape[1]
    keep = (jnp.arange(t, dtype=jnp.int32)[None, :] < valid[:, None])[..., None]
    n = jnp.maximum(valid, 2).astype(jnp.float32)[:, None, None]
    x = jnp.where(keep, feats.astype(jnp.float32), 0.0)
    mean = jnp.sum(x, axis=1, keepdims=True) / n
    centered = jnp.where(keep, x - mean, 0.0)
    var = jnp.sum(centered * centered, axis=1, keepdims=True) / (n - 1.0)
    normed = centered / (jnp.sqrt(var) + eps)
    return jnp.where(keep, normed, 0.0)
