"""STFT/ISTFT: round-trip reconstruction + torch.stft parity."""

import numpy as np
import pytest
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from asr_jax.frontend.stft import istft, power_spectrum, stft


def test_stft_matches_torch():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(8000).astype(np.float32)
    re, im = stft(jnp.asarray(x)[None], n_fft=400, hop_length=160, center=True)
    ref = torch.stft(
        torch.tensor(x), n_fft=400, hop_length=160,
        window=torch.hann_window(400), center=True, return_complex=True,
        pad_mode="reflect",
    ).numpy().T  # (T, n_bins)
    t = min(re.shape[1], ref.shape[0])
    np.testing.assert_allclose(np.asarray(re)[0, :t], ref.real[:t], rtol=2e-3, atol=5e-3)
    np.testing.assert_allclose(np.asarray(im)[0, :t], ref.imag[:t], rtol=2e-3, atol=5e-3)


def test_istft_round_trip():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(6400).astype(np.float32)
    re, im = stft(jnp.asarray(x)[None], n_fft=400, hop_length=100, center=True)
    y = istft(re, im, n_fft=400, hop_length=100, center=True, length=len(x))
    np.testing.assert_allclose(np.asarray(y)[0], x, rtol=2e-3, atol=5e-3)


def test_power_spectrum():
    re = jnp.asarray([[3.0]])
    im = jnp.asarray([[4.0]])
    assert float(power_spectrum(re, im)[0, 0]) == 25.0
