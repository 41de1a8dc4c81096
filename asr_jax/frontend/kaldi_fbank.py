"""Kaldi-faithful log-mel filterbank as one matmul.

Numerically matches ``torchaudio.compliance.kaldi.fbank(..., snip_edges=True,
dither=0, energy_floor=0)`` the same way the reference does (reference
``SenseVoice/Export_SenseVoice.py:136-160``): per-frame DC-offset removal,
pre-emphasis with replicate boundary, the symmetric Hamming window and the
one-sided ``n_fft``-point windowed DFT are **all linear in the frame**, so
they fold into a single analysis basis. The reference folds them into a
Conv1d kernel; here they fold into a ``(win, 2 * n_bins)`` matrix applied to
the framed signal — ``(B, T, win) @ (win, 2 * n_bins)`` — followed by
square/add/mel-matmul/log, which XLA fuses.

Kaldi convention: operates on the **int16 numeric range** (no ÷32768);
callers with [-1, 1] PCM pass ``input_scale=32768.0``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from asr_jax.frontend import framing
from asr_jax.frontend.mel_banks import kaldi_mel_banks

_F32_EPS = float(np.finfo(np.float32).eps)


def hamming_window(win: int) -> np.ndarray:
    """Symmetric (periodic=False) Hamming window, Kaldi's default for fbank."""
    n = np.arange(win, dtype=np.float64)
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * n / (win - 1))).astype(np.float32)


def povey_window(win: int) -> np.ndarray:
    """Kaldi's 'povey' window (hann ** 0.85), used by icefall/X-ASR fbank."""
    n = np.arange(win, dtype=np.float64)
    return ((0.5 - 0.5 * np.cos(2.0 * np.pi * n / (win - 1))) ** 0.85).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class KaldiFbankConfig:
    sample_rate: int = 16000
    n_mels: int = 80
    n_fft: int = 512           # Kaldi zero-pads the 400-sample frame to next pow2
    win_length: int = 400      # 25 ms
    hop_length: int = 160      # 10 ms
    pre_emphasis: float = 0.97
    window: str = "hamming"    # "hamming" | "povey"
    remove_dc: bool = True
    low_freq: float = 20.0
    mel_style: str = "kaldi"   # "kaldi" | "htk" (FireRedASR uses HTK banks)
    input_scale: float = 1.0   # multiply waveform before analysis (32768.0 for [-1,1] PCM)

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        return framing.num_frames_snip(num_samples, self.win_length, self.hop_length)


def _fold_frontend(basis: np.ndarray, pre_emphasis: float, remove_dc: bool) -> np.ndarray:
    """Fold pre-emphasis (replicate boundary) + DC removal into a windowed basis.

    ``basis`` is ``(n_bins, win)`` already multiplied by the window. Returns
    the folded ``(n_bins, win)`` kernel such that ``kernel @ frame`` equals
    ``basis @ window_fn(preemph(dc_remove(frame)))`` — identical math to
    reference ``Export_SenseVoice.py:146-151`` but built in numpy.
    """
    shifted = np.concatenate([basis[:, 1:], np.zeros_like(basis[:, :1])], axis=1)
    folded = basis - pre_emphasis * shifted      # pf[n] = s[n] - c * s[n-1]
    folded[:, 0] -= pre_emphasis * basis[:, 0]   # replicate boundary pf[0] = (1-c) s[0]
    if remove_dc:
        folded = folded - folded.mean(axis=1, keepdims=True)
    return folded


@functools.lru_cache(maxsize=16)
def _kaldi_constants(cfg: KaldiFbankConfig):
    """Build the folded DFT basis and mel bank once (host numpy, cached)."""
    win, n_fft, n_bins = cfg.win_length, cfg.n_fft, cfg.n_bins
    window = {"hamming": hamming_window, "povey": povey_window}[cfg.window](win)
    freqs = np.arange(n_bins, dtype=np.float32)[:, None]
    samples = np.arange(win, dtype=np.float32)[None, :]
    omega = (2.0 * np.pi / n_fft) * freqs * samples
    cos_basis = np.cos(omega, dtype=np.float32) * window
    sin_basis = -np.sin(omega, dtype=np.float32) * window
    kernel = np.concatenate(
        [
            _fold_frontend(cos_basis, cfg.pre_emphasis, cfg.remove_dc),
            _fold_frontend(sin_basis, cfg.pre_emphasis, cfg.remove_dc),
        ],
        axis=0,
    )  # (2 * n_bins, win)
    if cfg.input_scale != 1.0:
        kernel = kernel * np.float32(cfg.input_scale)
    k = -(-win // cfg.hop_length)
    basis = np.zeros((k * cfg.hop_length, 2 * n_bins), dtype=np.float32)
    basis[:win] = kernel.T  # zero rows past win make the matmul ignore frame scratch
    if cfg.mel_style == "htk":
        from asr_jax.frontend.mel_banks import htk_mel_banks

        mel = htk_mel_banks(cfg.n_mels, n_fft, cfg.sample_rate, cfg.low_freq)
    else:
        mel = kaldi_mel_banks(cfg.n_mels, n_fft, cfg.sample_rate, cfg.low_freq)
    return basis, mel


def log_mel_fbank(audio: jnp.ndarray, cfg: KaldiFbankConfig, n_frames: int) -> jnp.ndarray:
    """Compute Kaldi log-mel fbank features.

    Args:
      audio: ``(..., num_samples)`` waveform in the int16 numeric range
        (or scaled via ``cfg.input_scale``).
      cfg: filterbank configuration.
      n_frames: static number of frames to emit (pad/truncate framing).

    Returns:
      ``(..., n_frames, n_mels)`` float32 log-mel features,
      floored at log(FLT_EPSILON) like Kaldi.
    """
    # XLA owns this chain: it fuses square/sum/log into the matmuls.
    basis_np, mel_np = _kaldi_constants(cfg)
    basis, mel = jnp.asarray(basis_np), jnp.asarray(mel_np)
    frames = framing.frame_signal(
        audio.astype(jnp.float32), cfg.win_length, cfg.hop_length, n_frames
    )
    spectrum = jnp.dot(frames, basis, precision=jax.lax.Precision.HIGHEST)
    re, im = jnp.split(spectrum * spectrum, 2, axis=-1)
    power = re + im
    mel_feat = jnp.dot(power, mel, precision=jax.lax.Precision.HIGHEST)
    return jnp.log(jnp.maximum(mel_feat, _F32_EPS))


