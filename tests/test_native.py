"""Native C++ audio DSP: builds with g++, matches scipy/numpy references."""

import numpy as np
import pytest

from asr_jax import native

pytestmark = pytest.mark.skipif(not native.available(), reason="g++ toolchain unavailable")


def test_resample_matches_scipy_on_bandlimited_signal():
    from scipy.signal import resample_poly

    rng = np.random.default_rng(0)
    t = np.arange(48000) / 48000.0
    # Band-limited content well below the target Nyquist.
    x = sum(np.sin(2 * np.pi * f * t + p) for f, p in [(440, 0.1), (1200, 1.0), (3000, 2.0)])
    x = (x / 3).astype(np.float32)
    ours = native.resample(x, 48000, 16000)
    ref = resample_poly(x, 1, 3).astype(np.float32)
    assert len(ours) == len(ref)
    # Interior samples (edges differ slightly due to filter design details).
    s = slice(100, -100)
    err = np.abs(ours[s] - ref[s]).max()
    assert err < 5e-3, err


def test_resample_preserves_tone_frequency():
    sr1, sr2, f0 = 48000, 16000, 1000.0
    t = np.arange(sr1) / sr1
    x = np.sin(2 * np.pi * f0 * t).astype(np.float32)
    y = native.resample(x, sr1, sr2)
    spec = np.abs(np.fft.rfft(y[200:-200] * np.hanning(len(y) - 400)))
    peak = np.argmax(spec) * sr2 / (len(y) - 400)
    assert abs(peak - f0) < 5.0


def test_downmix_and_rms():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 1000)).astype(np.float32)
    np.testing.assert_allclose(native.downmix(x), x.mean(axis=0), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        native.rms(x[0]), float(np.sqrt(np.mean(x[0] ** 2))), rtol=1e-6
    )


def test_upsample_length_convention():
    x = np.zeros(16000, np.float32)
    y = native.resample(x, 16000, 48000)
    assert len(y) == 48000


def test_audio_ingest_uses_native_when_available():
    from asr_jax.runtime import audio as audio_io

    from asr_jax.runtime.examples import fixture_path

    out = audio_io.load_audio(fixture_path("en/test_sample.wav"), 16000)
    assert out.ndim == 1 and out.dtype == np.float32


def test_malformed_wav_rejected(tmp_path):
    """Hostile WAV headers must not crash the native loader: fmt chunk
    < 16 bytes (would be an OOB read) and a data chunk claiming 4 GiB
    (would be a huge alloc) both fail or truncate safely (ADVICE r1)."""
    import struct

    lib = native.get_lib()
    assert lib is not None

    def riff(chunks: bytes) -> bytes:
        return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks

    tiny_fmt = riff(b"fmt " + struct.pack("<I", 8) + struct.pack("<HHI", 1, 1, 16000))
    p1 = tmp_path / "tiny_fmt.wav"
    p1.write_bytes(tiny_fmt)

    good_fmt = b"fmt " + struct.pack("<I", 16) + struct.pack("<HHIIHH", 1, 1, 16000, 32000, 2, 16)
    huge = riff(good_fmt + b"data" + struct.pack("<I", 0xFFFF0000) + b"\x01\x00" * 16)
    p2 = tmp_path / "huge_data.wav"
    p2.write_bytes(huge)

    ok = riff(good_fmt + b"data" + struct.pack("<I", 8) + struct.pack("<4h", 100, -100, 200, -200))
    p3 = tmp_path / "ok.wav"
    p3.write_bytes(ok)

    from asr_jax.runtime.audio import load_audio_batch

    buf, valid = load_audio_batch([str(p1), str(p2), str(p3)], 16000, 64)
    assert valid[0] == 0                      # fmt too small -> silent zero row
    assert valid[1] <= 16                     # declared 4 GiB truncated to real bytes
    assert valid[2] == 4 and buf[2, 0] == 100.0


def test_hostile_fmt_chunk_size_rejected(tmp_path):
    """A fmt chunk declaring ~4 GiB must be rejected BEFORE allocation
    (bounded by bytes remaining in the file), not zero-initialized."""
    import struct

    def riff(body):
        return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body

    hostile = riff(b"fmt " + struct.pack("<I", 0xFFFFFFF0) +
                   struct.pack("<HHIIHH", 1, 1, 16000, 32000, 2, 16))
    p = tmp_path / "hostile_fmt.wav"
    p.write_bytes(hostile)

    from asr_jax.runtime.audio import load_audio_batch

    buf, valid = load_audio_batch([str(p)], 16000, 64)
    assert valid[0] == 0
