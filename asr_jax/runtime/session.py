"""Inference sessions: file/array in -> text out, with RTF reporting.

The runtime equivalent of the reference's per-family ``Inference_*_ONNX.py``
drivers (SURVEY.md §2.7): sliding-window long-audio orchestration, padded
fixed-shape device calls, tokenizer decode and real-time-factor metrics —
but with one jitted function per model instead of ORT sessions + IOBinding
(state stays device-resident inside the jit, so there is nothing to bind).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from asr_jax.models import sensevoice as sv
from asr_jax.runtime import audio as audio_io
from asr_jax.runtime.metadata import ModelMetadata


@dataclasses.dataclass
class TranscribeResult:
    text: str
    token_ids: list[int]
    audio_seconds: float
    elapsed_seconds: float   # wall-clock latency of the device call that
    #                          produced this result (for batched calls: the
    #                          whole batch's latency — see batch_size)
    batch_size: int = 1      # items sharing that device call; aggregate
    #                          throughput RTF = rtf / batch_size

    @property
    def rtf(self) -> float:
        return self.elapsed_seconds / max(self.audio_seconds, 1e-9)


def bucket_windows(num: int) -> int:
    """Round a window count up to the next power of two so the jitted
    forward compiles once per bucket instead of once per audio length
    (the reference amortizes via fixed IOBinding buffers; fixed-shape
    buckets are the XLA equivalent). Padded windows carry valid=0."""
    n = 1
    while n < num:
        n *= 2
    return n


class SenseVoiceSession:
    """Batched sliding-window SenseVoice inference.

    Long audio is split into fixed windows (reference
    ``SenseVoice/Inference_SenseVoice_ONNX.py:247-263``), windows run as one
    padded batch in a single device call, and the per-window token ids are
    concatenated in order.
    """

    def __init__(
        self,
        params,
        cfg: sv.SenseVoiceConfig,
        tokenizer=None,
        metadata: ModelMetadata | None = None,
        window_seconds: float = 8.0,
        mesh=None,
        window_stride_seconds: float | None = None,
        param_specs=None,
    ):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.metadata = metadata
        self.window_samples = int(window_seconds * cfg.sample_rate)
        # Optional overlapping windows (reference SLIDING_WINDOW stride,
        # ``SenseVoice/Inference_SenseVoice_ONNX.py:247-263``; transcripts
        # concatenate window-by-window, same as the reference).
        self.stride_samples = (
            int(window_stride_seconds * cfg.sample_rate)
            if window_stride_seconds else self.window_samples
        )
        assert 0 < self.stride_samples <= self.window_samples
        self.runner = None
        if mesh is not None:
            from asr_jax.parallel.serve import DataParallelRunner

            self.runner = DataParallelRunner(mesh, param_specs=param_specs)
            params = self.runner.shard_params(params)
        self.params = params

    def language_index(self, language: str) -> int:
        for i, (code, desc, aliases, _tok) in enumerate(sv.LANGUAGE_PROFILES):
            if language.lower() in (code, desc.lower(), *(a.lower() for a in aliases)):
                return i
        raise KeyError(f"unsupported language {language!r}")

    def transcribe(
        self, audio: np.ndarray | str | Path, language: str = "auto"
    ) -> TranscribeResult:
        if isinstance(audio, (str, Path)):
            audio = audio_io.load_audio(audio, self.cfg.sample_rate)
        audio = np.asarray(audio, dtype=np.float32)
        n = len(audio)
        w = self.window_samples
        stride = self.stride_samples
        starts = audio_io.iter_windows(n, w, stride)
        num_windows = len(starts)
        padded = bucket_windows(num_windows)
        buf = np.zeros((padded, w), dtype=np.float32)
        valid = np.zeros((padded,), dtype=np.int32)
        for i, s in enumerate(starts):
            chunk = audio[s : s + w]
            buf[i, : len(chunk)] = chunk
            valid[i] = len(chunk)
        lang_idx = np.full((padded,), self.language_index(language), dtype=np.int32)

        t0 = time.perf_counter()
        if self.runner is not None:
            toks, counts = self.runner(
                lambda p, a, v, li: sv.forward(p, self.cfg, a, v, li),
                self.params, buf, valid, lang_idx,
            )
        else:
            toks, counts = sv.forward(
                self.params, self.cfg, jnp.asarray(buf), jnp.asarray(valid), jnp.asarray(lang_idx)
            )
        toks = np.asarray(jax.block_until_ready(toks))
        counts = np.asarray(counts)
        elapsed = time.perf_counter() - t0

        ids: list[int] = []
        for i in range(num_windows):
            ids.extend(int(t) for t in toks[i, : counts[i]])
        text = self.tokenizer.decode(ids) if self.tokenizer is not None else ""
        return TranscribeResult(
            text=text,
            token_ids=ids,
            audio_seconds=n / self.cfg.sample_rate,
            elapsed_seconds=elapsed,
        )

    def transcribe_batch(
        self, paths, language: str = "auto", n_threads: int = 0
    ) -> list[TranscribeResult]:
        """Many short files -> ONE device dispatch: the native parallel
        batch loader fills a fixed (N, window) buffer and every file rides
        the same jitted forward (files longer than one window fall back to
        the sliding-window path)."""
        buf, valid = audio_io.load_audio_batch(
            paths, self.cfg.sample_rate, self.window_samples, n_threads=n_threads
        )
        lang_idx = np.full((len(paths),), self.language_index(language), np.int32)
        valid_clip = np.minimum(valid, self.window_samples).astype(np.int32)
        t0 = time.perf_counter()
        if self.runner is not None:
            # Same data-parallel route as transcribe(): --data-parallel must
            # shard exactly this multi-file batch, not silently no-op.
            toks, counts = self.runner(
                lambda p, a, v, li: sv.forward(p, self.cfg, a, v, li),
                self.params, buf, valid_clip, lang_idx,
            )
        else:
            toks, counts = sv.forward(
                self.params, self.cfg, jnp.asarray(buf),
                jnp.asarray(valid_clip), jnp.asarray(lang_idx),
            )
        toks = np.asarray(jax.block_until_ready(toks))
        counts = np.asarray(counts)
        elapsed = time.perf_counter() - t0
        results = []
        for i, path in enumerate(paths):
            if valid[i] > self.window_samples:
                # longer than one window: sliding-window path, full audio
                results.append(self.transcribe(path, language=language))
                continue
            ids = [int(t) for t in toks[i, : counts[i]]]
            results.append(TranscribeResult(
                text=self.tokenizer.decode(ids) if self.tokenizer else "",
                token_ids=ids,
                audio_seconds=float(valid[i]) / self.cfg.sample_rate,
                elapsed_seconds=elapsed,       # true latency of the shared call
                batch_size=len(paths),         # divide rtf by this for throughput
            ))
        return results

    def warmup(self) -> None:
        silent = np.zeros(self.window_samples, dtype=np.float32)
        self.transcribe(silent)

    # ── windowed-session protocol (used by parallel.http_server) ──────────
    pcm_scale = 32768.0
    sample_rate = 16000

    def _forward(self, params, audio: jnp.ndarray, valid: jnp.ndarray, language: str = "auto"):
        lang = jnp.full((audio.shape[0],), self.language_index(language), jnp.int32)
        return sv.forward(params, self.cfg, audio, valid, lang)

    def _postprocess(self, text: str) -> str:
        return text
