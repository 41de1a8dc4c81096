"""Demo audio: the registry of (language, fixture) cases per model family
(reference ``Example_Audio.py``) and seeded stand-ins for its fixtures.

The reference ships real recordings under ``Test_Examples/``; pass that
directory as ``root`` to use them. Without it, :func:`write_examples`
generates stand-ins at the same relative paths with the same sample rate
and channel layout: speech-like synthetic audio (harmonics of a gliding
pitch under a syllable-rate envelope, plus noise) made from a seed. MP3
files cannot be generated here (there is no encoder), so their cases are
skipped unless a directory that holds them is given.
"""

from __future__ import annotations

import io
import os
import struct
import wave
from pathlib import Path

import numpy as np

# Generated stand-ins beside the checkout (listed in .gitignore).
EXAMPLES_DIR = Path(__file__).resolve().parents[2] / ".examples"

# relative path -> (sample rate, channels, frames)
FIXTURES: dict[str, tuple[int, int, int]] = {
    "en/test_sample.wav": (48000, 2, 268292),    # 5.59 s, 48 kHz stereo
    "zh/zh-Shanghai.wav": (16000, 1, 112000),    # 7 s, 16 kHz mono
    "zh/zh-Shanghai.flac": (16000, 1, 112000),   # the same samples as FLAC
}

_MODEL_AUDIO_FILES: dict[str, list[tuple[str, str]]] = {
    "sensevoice": [("en", "en/test_sample.wav"), ("zh", "zh/zh-Shanghai.wav")],
    "whisper": [("en", "en/test_sample.wav")],
    "paraformer": [("zh", "zh/zh-Shanghai.wav")],
    "paraformer_streaming": [("zh", "zh/zh-Shanghai.wav")],
    "firered": [("zh", "zh/zh-Shanghai.wav")],
    "dolphin": [("zh", "zh/zh-Shanghai.wav"), ("ja", "ja/ja.mp3")],
    "dolphin_streaming": [("zh", "zh/zh-Shanghai.wav")],
    "fun_asr_nano": [("zh", "zh/zh-Shanghai.wav"), ("en", "en/en.mp3")],
    "qwen_asr": [("en", "en/test_sample.wav"), ("zh", "zh/zh-Shanghai.wav")],
    "forced_aligner": [("en", "en/test_sample.wav")],
    "parakeet": [("en", "en/test_sample.wav"), ("ko", "ko/ko.mp3")],
    "nemotron": [("en", "en/test_sample.wav"), ("yue", "yue/yue.mp3")],
    "xasr": [("zh", "zh/zh-Shanghai.wav"), ("en", "en/test_sample.wav")],
}


def synth_audio(n_frames: int, rate: int, channels: int = 1,
                seed: int = 0) -> np.ndarray:
    """(n_frames, channels) int16 speech-like audio, a pure function of
    its arguments."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames) / rate
    f0 = 110.0 + 60.0 * np.sin(2 * np.pi * rng.uniform(0.2, 0.5) * t
                               + rng.uniform(0, 2 * np.pi))
    phase = 2 * np.pi * np.cumsum(f0) / rate
    voiced = sum(np.sin(k * phase + rng.uniform(0, 2 * np.pi)) / k
                 for k in range(1, 9))
    envelope = np.clip(np.sin(2 * np.pi * 4.0 * t + rng.uniform(0, 2 * np.pi)),
                       0.0, None) ** 2
    mono = voiced * envelope + 0.05 * rng.standard_normal(n_frames)
    chans = [mono * (1.0 - 0.2 * c) + 0.02 * rng.standard_normal(n_frames)
             for c in range(channels)]
    pcm = np.stack(chans, axis=1)
    pcm = pcm / np.abs(pcm).max() * 0.4 * 32767
    return pcm.astype(np.int16)


def wav_bytes(pcm: np.ndarray, rate: int) -> bytes:
    """int16 (frames,) or (frames, channels) -> 16-bit PCM WAV bytes."""
    pcm = np.asarray(pcm, np.int16)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.astype("<i2").tobytes())
    return buf.getvalue()


def _crc_table(poly: int, width: int) -> list[int]:
    top, mask, table = 1 << (width - 1), (1 << width) - 1, []
    for byte in range(256):
        crc = byte << (width - 8)
        for _ in range(8):
            crc = (((crc << 1) ^ poly) if crc & top else crc << 1) & mask
        table.append(crc)
    return table


_CRC8, _CRC16 = _crc_table(0x07, 8), _crc_table(0x8005, 16)


def _crc8(data: bytes) -> int:
    crc = 0
    for byte in data:
        crc = _CRC8[crc ^ byte]
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for byte in data:
        crc = ((crc << 8) & 0xFFFF) ^ _CRC16[(crc >> 8) ^ byte]
    return crc


def flac_bytes(pcm: np.ndarray, rate: int, block: int = 4096) -> bytes:
    """int16 (frames,) or (frames, channels) -> FLAC bytes with verbatim
    subframes (lossless, uncompressed; every field byte-aligned)."""
    pcm = np.asarray(pcm, np.int16)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    n, channels = pcm.shape
    n_frames = -(-n // block)
    if n_frames > 128:
        raise ValueError("frame numbers above 127 need multi-byte UTF-8 coding")
    info = struct.pack(">HH", block, block) + b"\0" * 6
    info += ((rate << 44) | ((channels - 1) << 41) | (15 << 36) | n).to_bytes(8, "big")
    out = [b"fLaC", bytes([0x80, 0, 0, 34]), info, b"\0" * 16]
    for idx in range(n_frames):
        frame = pcm[idx * block:(idx + 1) * block]
        # sync, fixed blocksize, 16-bit size field, rate from STREAMINFO,
        # independent channels, 16 bits/sample, frame number, size - 1
        head = struct.pack(">HBB", 0xFFF8, 0x70, ((channels - 1) << 4) | 0x08)
        head += bytes([idx]) + struct.pack(">H", len(frame) - 1)
        body = head + bytes([_crc8(head)])
        for c in range(channels):
            body += b"\x02" + frame[:, c].astype(">i2").tobytes()
        out.append(body + struct.pack(">H", _crc16(body)))
    return b"".join(out)


def write_examples(root: Path, seed: int = 0) -> Path:
    """Write the seeded stand-ins for :data:`FIXTURES` under ``root``
    (skipping files already there) and return ``root``."""
    root = Path(root)
    stems = sorted({Path(r).stem for r in FIXTURES})
    for rel, (rate, channels, frames) in sorted(FIXTURES.items()):
        path = root / rel
        if path.exists():
            continue
        # the WAV and FLAC of one stem hold the same samples
        stem_seed = seed * 1000 + stems.index(path.stem)
        pcm = synth_audio(frames, rate, channels, seed=stem_seed)
        data = flac_bytes(pcm, rate) if path.suffix == ".flac" else wav_bytes(pcm, rate)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".{path.name}.{os.getpid()}")
        tmp.write_bytes(data)
        os.replace(tmp, path)  # concurrent writers never expose a partial file
    return root


def fixture_path(rel: str) -> Path:
    """Absolute path of a generated stand-in (written on first use)."""
    return write_examples(EXAMPLES_DIR) / rel


def model_audio_cases(family: str, root: Path | None = None) -> list[tuple[str, Path]]:
    """[(language, absolute path)] demo cases for a family; skips files the
    runtime cannot decode (mp3 without libmpg123) or that are absent."""
    root = root or write_examples(EXAMPLES_DIR)
    out = []
    for lang, rel in _MODEL_AUDIO_FILES.get(family, []):
        p = root / rel
        if p.suffix == ".mp3":
            from asr_jax.runtime.mp3 import mpg123_available

            if not mpg123_available():
                continue
        if p.exists():
            out.append((lang, p))
    return out
