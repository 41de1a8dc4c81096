"""FLAC decoder: bit-exact round trips against a minimal in-test encoder
(verbatim / constant / fixed+Rice subframes, mono + left/side stereo),
load_audio integration and the HTTP body sniffer."""

import numpy as np
import pytest

from asr_jax.runtime.flac import read_flac


class _BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def write(self, val: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bits.append((val >> i) & 1)

    def write_signed(self, val: int, n: int) -> None:
        self.write(val & ((1 << n) - 1), n)

    def align(self) -> None:
        while len(self.bits) % 8:
            self.bits.append(0)

    def bytes(self) -> bytes:
        self.align()
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for bit in self.bits[i:i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


def _streaminfo(block_size, rate, channels, depth, total) -> bytes:
    w = _BitWriter()
    w.write(1, 1)          # last metadata block
    w.write(0, 7)          # STREAMINFO
    w.write(34, 24)
    w.write(block_size, 16)
    w.write(block_size, 16)
    w.write(0, 24)
    w.write(0, 24)
    w.write(rate, 20)
    w.write(channels - 1, 3)
    w.write(depth - 1, 5)
    w.write(total, 36)
    w.write(0, 128)        # md5 (unchecked)
    return w.bytes()


_DEPTH_CODE = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6}


def _frame_header(w, block_size, chan_code, depth_code, frame_idx):
    w.write(0x3FFE, 14)
    w.write(0, 1)
    w.write(0, 1)          # fixed blocksize strategy
    w.write(7, 4)          # 16-bit blocksize-1 follows
    w.write(0, 4)          # rate: from STREAMINFO
    w.write(chan_code, 4)
    w.write(depth_code, 3)
    w.write(0, 1)
    assert frame_idx < 128
    w.write(frame_idx, 8)  # utf8 single byte
    w.write(block_size - 1, 16)
    w.write(0, 8)          # crc8 (decoder skips)


def _verbatim(w, samples, depth):
    w.write(0, 1)
    w.write(1, 6)
    w.write(0, 1)
    for s in samples:
        w.write_signed(int(s), depth)


def _constant(w, value, depth):
    w.write(0, 1)
    w.write(0, 6)
    w.write(0, 1)
    w.write_signed(int(value), depth)


def _fixed2_rice(w, samples, depth, rice_k=4):
    """FIXED order-2 subframe, single Rice partition."""
    w.write(0, 1)
    w.write(10, 6)         # fixed, order 2
    w.write(0, 1)
    w.write_signed(int(samples[0]), depth)
    w.write_signed(int(samples[1]), depth)
    w.write(0, 2)          # residual method 0 (4-bit rice)
    w.write(0, 4)          # partition order 0
    w.write(rice_k, 4)
    for i in range(2, len(samples)):
        e = int(samples[i]) - (2 * int(samples[i - 1]) - int(samples[i - 2]))
        u = (e << 1) ^ (e >> 63)  # zigzag
        q, r = u >> rice_k, u & ((1 << rice_k) - 1)
        w.write(0, q)
        w.write(1, 1)
        w.write(r, rice_k)


def _encode(frames, rate=16000, channels=1, depth=16, chan_code=None,
            block_size=None) -> bytes:
    def _n(sub):
        return len(sub[1]) if isinstance(sub, tuple) else len(sub)

    block_size = block_size or _n(frames[0][0])
    total = sum(_n(f[0]) for f in frames)
    out = b"fLaC" + _streaminfo(block_size, rate, channels, depth, total)
    for idx, chans in enumerate(frames):
        w = _BitWriter()
        cc = chan_code if chan_code is not None else channels - 1
        _frame_header(w, _n(chans[0]), cc, _DEPTH_CODE[depth], idx)
        for sub in chans:
            if isinstance(sub, tuple):
                kind, data, d = sub
            else:
                kind, data, d = "verbatim", sub, depth
            if kind == "verbatim":
                _verbatim(w, data, d)
            elif kind == "constant":
                _constant(w, data[0], d)
            elif kind == "fixed2":
                _fixed2_rice(w, data, d)
        w.align()
        w.write(0, 16)     # crc16 (decoder skips)
        out += w.bytes()
    return out


def test_mono_verbatim_fixed_constant_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.integers(-3000, 3000, 64).astype(np.int64)
    b = np.cumsum(rng.integers(-40, 40, 64)).astype(np.int64) + 100  # smooth: fixed2
    c = np.full(64, -777, np.int64)
    blob = _encode([
        [("verbatim", a, 16)],
        [("fixed2", b, 16)],
        [("constant", c, 16)],
    ])
    p = tmp_path / "t.flac"
    p.write_bytes(blob)
    samples, rate = read_flac(p)
    assert rate == 16000
    want = np.concatenate([a, b, c]).astype(np.float32)
    np.testing.assert_array_equal(samples, want)


def test_stereo_left_side_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    left = rng.integers(-2000, 2000, 48).astype(np.int64)
    right = rng.integers(-2000, 2000, 48).astype(np.int64)
    side = left - right
    blob = _encode([[("verbatim", left, 16), ("verbatim", side, 17)]],
                   channels=2, chan_code=8)
    p = tmp_path / "s.flac"
    p.write_bytes(blob)
    samples, rate = read_flac(p)
    assert samples.shape == (48, 2)
    np.testing.assert_array_equal(samples[:, 0], left.astype(np.float32))
    np.testing.assert_array_equal(samples[:, 1], right.astype(np.float32))


def test_8bit_depth_scales_to_int16_range(tmp_path):
    a = np.asarray([-128, -1, 0, 1, 127] * 8, np.int64)
    blob = _encode([[("verbatim", a, 8)]], depth=8)
    p = tmp_path / "d8.flac"
    p.write_bytes(blob)
    samples, _ = read_flac(p)
    np.testing.assert_array_equal(samples, a.astype(np.float32) * 256.0)


def test_load_audio_flac_resamples(tmp_path):
    from asr_jax.runtime.audio import load_audio

    rng = np.random.default_rng(2)
    a = rng.integers(-2000, 2000, 160).astype(np.int64)
    p = tmp_path / "r.flac"
    p.write_bytes(_encode([[("verbatim", a, 16)]], rate=8000))
    mono = load_audio(p, 16000)
    assert mono.ndim == 1 and abs(len(mono) - 320) <= 2


def test_http_body_sniffer_decodes_flac_and_rejects_junk():
    from asr_jax.parallel.http_server import decode_audio_bytes

    rng = np.random.default_rng(3)
    a = rng.integers(-2000, 2000, 64).astype(np.int64)
    blob = _encode([[("verbatim", a, 16)]])
    got = decode_audio_bytes(blob, 16000)
    np.testing.assert_array_equal(got, a.astype(np.float32))
    with pytest.raises(ValueError, match="unrecognized audio body"):
        decode_audio_bytes(b"\x00\x01junkjunk", 16000)


def test_bad_magic_raises(tmp_path):
    p = tmp_path / "x.flac"
    p.write_bytes(b"NOPE" + b"\x00" * 64)
    with pytest.raises(ValueError, match="fLaC"):
        read_flac(p)


def test_native_flac_decoder_matches_python(tmp_path):
    """The C++ decoder (native.flac_decode) must be bit-identical to the
    pure-Python reference on every subframe kind and stereo mode."""
    from asr_jax import native

    if not native.available():
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(4)
    a = rng.integers(-3000, 3000, 64).astype(np.int64)
    b = np.cumsum(rng.integers(-40, 40, 64)).astype(np.int64)
    c = np.full(64, 123, np.int64)
    blob = _encode([
        [("verbatim", a, 16)],
        [("fixed2", b, 16)],
        [("constant", c, 16)],
    ])
    samples, rate, depth = native.flac_decode(blob)
    assert (rate, depth) == (16000, 16)
    np.testing.assert_array_equal(samples, np.concatenate([a, b, c]))

    left = rng.integers(-2000, 2000, 48).astype(np.int64)
    right = rng.integers(-2000, 2000, 48).astype(np.int64)
    blob2 = _encode([[("verbatim", left, 16), ("verbatim", left - right, 17)]],
                    channels=2, chan_code=8)
    s2, _, _ = native.flac_decode(blob2)
    np.testing.assert_array_equal(s2[:, 0], left)
    np.testing.assert_array_equal(s2[:, 1], right)

    with pytest.raises(ValueError):
        native.flac_decode(b"NOPE" + b"\x00" * 64)

    # read_flac (native-first path) agrees with the direct call
    p = tmp_path / "n.flac"
    p.write_bytes(blob)
    got, rr = read_flac(p)
    assert rr == 16000
    np.testing.assert_array_equal(got, np.concatenate([a, b, c]).astype(np.float32))
