"""Espnet DefaultFrontend log-mel (Dolphin/OWSM convention).

Reference ``Dolphin/v1/Export_Dolphin.py:654-667``: [-1,1] PCM (int16 scale
folded), optional pre-emphasis, center-padded STFT (reflect) with a
periodic Hann window zero-padded from win_length to n_fft, power spectrum,
Slaney mel (f_min = 0), ``clamp(1e-10).log()`` (natural log), then global
CMVN ``(x - mean) * inv_std`` applied by the model. The trailing frame is
KEPT (frames = 1 + n // hop), unlike Whisper/NeMo.
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
class EspnetMelConfig:
    sample_rate: int = 16000
    n_mels: int = 80
    n_fft: int = 512
    win_length: int = 400
    hop_length: int = 160
    preemphasis: float = 0.0
    input_scale: float = 1.0  # 1/32768 for int16-range input

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        return num_samples // self.hop_length + 1

    def valid_frames(self, valid_samples: jnp.ndarray) -> jnp.ndarray:
        return (jnp.asarray(valid_samples, jnp.int32) // self.hop_length + 1).astype(jnp.int32)


def hann_window_periodic(win: int) -> np.ndarray:
    n = np.arange(win, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win)).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _espnet_constants(cfg: EspnetMelConfig):
    pad_total = cfg.n_fft - cfg.win_length
    pad_l = pad_total // 2
    win = np.zeros(cfg.n_fft, np.float32)
    win[pad_l : pad_l + cfg.win_length] = hann_window_periodic(cfg.win_length)
    freqs = np.arange(cfg.n_bins, dtype=np.float32)[:, None]
    samples = np.arange(cfg.n_fft, dtype=np.float32)[None, :]
    omega = (2.0 * np.pi / cfg.n_fft) * freqs * samples
    kernel = np.concatenate(
        [np.cos(omega, dtype=np.float32) * win, -np.sin(omega, dtype=np.float32) * win], axis=0
    )
    k = -(-cfg.n_fft // cfg.hop_length)
    basis = np.zeros((k * cfg.hop_length, 2 * cfg.n_bins), np.float32)
    basis[: cfg.n_fft] = kernel.T
    mel = slaney_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sample_rate, fmin=0.0)
    return basis, mel


def log_mel(audio: jnp.ndarray, cfg: EspnetMelConfig) -> jnp.ndarray:
    """(..., S) -> (..., 1 + S // hop, n_mels) natural-log mel."""
    basis_np, mel_np = _espnet_constants(cfg)
    basis, mel = jnp.asarray(basis_np), jnp.asarray(mel_np)
    x = audio.astype(jnp.float32) * cfg.input_scale
    if cfg.preemphasis > 0:
        prev = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(1, 0)])[..., :-1]
        first = x[..., :1]
        x = jnp.concatenate([first, (x - cfg.preemphasis * prev)[..., 1:]], axis=-1)
    pad = cfg.n_fft // 2
    x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    n_frames = cfg.num_frames(audio.shape[-1])
    frames = framing.frame_signal(x, cfg.n_fft, cfg.hop_length, n_frames)
    spec = jnp.dot(frames, basis, precision=jax.lax.Precision.HIGHEST)
    re, im = jnp.split(spec * spec, 2, axis=-1)
    melspec = jnp.dot(re + im, mel, precision=jax.lax.Precision.HIGHEST)
    return jnp.log(jnp.maximum(melspec, 1e-10))
