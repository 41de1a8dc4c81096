"""Front-end numerics: framing, Kaldi fbank, Whisper mel, LFR, CMVN.

The Kaldi path is validated against an *independent* step-by-step numpy
implementation (frame -> DC removal -> pre-emphasis -> Hamming -> zero-pad
FFT -> power -> mel -> log floor), i.e. the textbook pipeline the folded
matmul basis must reproduce. The Whisper path is validated against the HF
``WhisperFeatureExtractor`` golden implementation.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from asr_jax.frontend import (
    KaldiFbankConfig,
    WhisperMelConfig,
    apply_cmvn_addmul,
    frame_signal,
    kaldi_mel_banks,
    lfr_stack,
    log_mel_fbank,
    log_mel_spectrogram,
    num_frames_snip,
    slaney_mel_banks,
)


def naive_kaldi_fbank(audio: np.ndarray, cfg: KaldiFbankConfig) -> np.ndarray:
    """Textbook Kaldi fbank (dither=0, snip_edges, energy_floor n/a)."""
    win, hop, nfft = cfg.win_length, cfg.hop_length, cfg.n_fft
    n = num_frames_snip(len(audio), win, hop)
    window = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(win) / (win - 1))
    mel = kaldi_mel_banks(cfg.n_mels, nfft, cfg.sample_rate, cfg.low_freq).astype(np.float64)
    out = np.zeros((n, cfg.n_mels))
    for m in range(n):
        frame = audio[m * hop : m * hop + win].astype(np.float64) * cfg.input_scale
        frame = frame - frame.mean()
        pre = np.empty_like(frame)
        pre[1:] = frame[1:] - cfg.pre_emphasis * frame[:-1]
        pre[0] = frame[0] - cfg.pre_emphasis * frame[0]
        windowed = pre * window
        spec = np.fft.rfft(windowed, n=nfft)
        power = np.abs(spec) ** 2
        out[m] = np.log(np.maximum(power @ mel, np.finfo(np.float32).eps))
    return out.astype(np.float32)


def test_frame_signal_matches_strided():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4000).astype(np.float32)
    win, hop = 400, 160
    n = num_frames_snip(len(x), win, hop)
    frames = np.asarray(frame_signal(jnp.asarray(x), win, hop, n))
    for m in range(n):
        np.testing.assert_array_equal(frames[m, :win], x[m * hop : m * hop + win])


def test_kaldi_fbank_matches_naive():
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal(16000 * 2) * 3000).astype(np.float32)
    cfg = KaldiFbankConfig()
    n = cfg.num_frames(len(audio))
    ours = np.asarray(log_mel_fbank(jnp.asarray(audio), cfg, n))
    ref = naive_kaldi_fbank(audio, cfg)
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-4)


def test_kaldi_fbank_batched_and_input_scale():
    rng = np.random.default_rng(2)
    audio = rng.standard_normal((3, 8000)).astype(np.float32) * 0.1
    cfg = KaldiFbankConfig(input_scale=32768.0)
    n = cfg.num_frames(audio.shape[-1])
    ours = np.asarray(log_mel_fbank(jnp.asarray(audio), cfg, n))
    assert ours.shape == (3, n, 80)
    ref = naive_kaldi_fbank(audio[1], cfg)
    np.testing.assert_allclose(ours[1], ref, rtol=2e-4, atol=2e-4)


def test_slaney_mel_banks_match_transformers():
    transformers = pytest.importorskip("transformers")
    from transformers.audio_utils import mel_filter_bank

    golden = mel_filter_bank(
        num_frequency_bins=201,
        num_mel_filters=128,
        min_frequency=0.0,
        max_frequency=8000.0,
        sampling_rate=16000,
        norm="slaney",
        mel_scale="slaney",
    )
    ours = slaney_mel_banks(128, 400, 16000)
    np.testing.assert_allclose(ours, golden, rtol=1e-5, atol=1e-7)


def test_whisper_mel_matches_hf_feature_extractor():
    transformers = pytest.importorskip("transformers")
    from transformers import WhisperFeatureExtractor

    fe = WhisperFeatureExtractor(feature_size=128, sampling_rate=16000)
    rng = np.random.default_rng(3)
    audio = (rng.standard_normal(16000 * 4) * 0.1).astype(np.float32)
    golden = fe(
        audio, sampling_rate=16000, return_tensors="np", padding="max_length"
    ).input_features[0].T  # (frames, mels)
    cfg = WhisperMelConfig(n_mels=128)
    padded = np.zeros(480000, dtype=np.float32)
    padded[: len(audio)] = audio
    ours = np.asarray(log_mel_spectrogram(jnp.asarray(padded), cfg))
    assert ours.shape == golden.shape
    np.testing.assert_allclose(ours, golden, rtol=1e-3, atol=2e-4)


def test_lfr_stack_matches_naive():
    rng = np.random.default_rng(4)
    t, d, m, n = 37, 5, 7, 6
    feats = rng.standard_normal((t, d)).astype(np.float32)
    ours = np.asarray(lfr_stack(jnp.asarray(feats), m, n, valid_frames=t))
    t_lfr = (t + n - 1) // n
    assert ours.shape == (t_lfr, d * m)
    for i in range(t_lfr):
        idx = np.clip(np.arange(i * n - (m - 1) // 2, i * n - (m - 1) // 2 + m), 0, t - 1)
        np.testing.assert_array_equal(ours[i], feats[idx].reshape(-1))


def test_lfr_stack_padded_matches_exact():
    """Fixed-shape padded input + valid_frames clamp == exact-length run."""
    rng = np.random.default_rng(5)
    t_valid, t_pad, d = 31, 64, 4
    feats = rng.standard_normal((t_valid, d)).astype(np.float32)
    padded = np.zeros((t_pad, d), dtype=np.float32)
    padded[:t_valid] = feats
    exact = np.asarray(lfr_stack(jnp.asarray(feats), 7, 6, valid_frames=t_valid))
    from_padded = np.asarray(lfr_stack(jnp.asarray(padded), 7, 6, valid_frames=t_valid))
    np.testing.assert_array_equal(from_padded[: exact.shape[0]], exact)


def test_lfr_batched_per_sample_clamp():
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((2, 24, 3)).astype(np.float32)
    valid = np.array([24, 13], dtype=np.int32)
    ours = np.asarray(lfr_stack(jnp.asarray(feats), 7, 6, valid_frames=jnp.asarray(valid)))
    single = np.asarray(lfr_stack(jnp.asarray(feats[1]), 7, 6, valid_frames=13))
    np.testing.assert_array_equal(ours[1], single)


def test_cmvn():
    x = jnp.ones((2, 3))
    means = jnp.full((3,), -0.5)
    istd = jnp.full((3,), 2.0)
    np.testing.assert_allclose(np.asarray(apply_cmvn_addmul(x, means, istd)), 1.0)
