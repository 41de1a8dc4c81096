"""Streaming sessions: chunked transcription with device-resident state.

Runtime parity with the reference streaming drivers (SURVEY.md §3.5):
fixed-size audio chunks, cache pytrees carried across jitted steps, the
decoder invoked only when the predictor fired, RMS-matched white-noise
final padding (reference ``Inference_Paraformer_Streaming_ONNX.py:352-362``)
and per-chunk RTF reporting.
"""

from __future__ import annotations

import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from asr_jax.runtime import audio as audio_io
from asr_jax.runtime.session import TranscribeResult
from asr_jax.streaming import paraformer_online as po


class ParaformerStreamingSession:
    def __init__(self, params, cfg: po.ParaformerStreamConfig, tokenizer=None):
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.reset()

    def reset(self) -> None:
        self.state = po.init_state(self.cfg, self.params)
        self.token_ids: list[int] = []
        self.elapsed = 0.0
        self.audio_samples = 0

    def push_chunk(self, chunk: np.ndarray) -> list[int]:
        """Feed one fixed-size chunk; returns newly decoded token ids."""
        assert len(chunk) == self.cfg.chunk_samples, "fixed-size chunks required"
        t0 = time.perf_counter()
        self.state, fired, count, enc_out = po.encoder_step(
            self.params, self.cfg, self.state, jnp.asarray(chunk, jnp.float32)[None]
        )
        n_fired = int(count)  # the reference's single scalar host read per chunk
        new_ids: list[int] = []
        if n_fired > 0:
            self.state, ids, _ = po.decoder_step(
                self.params, self.cfg, self.state, enc_out, fired, count
            )
            new_ids = [int(t) for t in np.asarray(ids)[0, :n_fired]]
            self.token_ids.extend(new_ids)
        self.elapsed += time.perf_counter() - t0
        self.audio_samples += len(chunk)
        return new_ids

    def transcribe(self, audio: np.ndarray | str | Path) -> TranscribeResult:
        if isinstance(audio, (str, Path)):
            audio = audio_io.load_audio(audio, self.cfg.base.sample_rate)
        audio = np.asarray(audio, np.float32)
        self.reset()
        w = self.cfg.chunk_samples
        n = len(audio)
        num_chunks = -(-n // w)
        rng = np.random.default_rng(0)
        for i in range(num_chunks):
            chunk = audio[i * w : (i + 1) * w]
            if len(chunk) < w:
                # RMS-matched white-noise pad (reference: zero padding biases
                # the CIF tail; matched noise keeps the fbank energy profile).
                rms = float(np.sqrt(np.mean(np.square(chunk)))) if len(chunk) else 1.0
                pad = (rng.standard_normal(w - len(chunk)) * max(rms, 1e-3)).astype(np.float32)
                chunk = np.concatenate([chunk, pad])
            self.push_chunk(chunk)
        text = self.tokenizer.decode(self.token_ids) if self.tokenizer else ""
        return TranscribeResult(
            text=text,
            token_ids=list(self.token_ids),
            audio_seconds=n / self.cfg.base.sample_rate,
            elapsed_seconds=self.elapsed,
        )


def snip_edges_false_pad(waveform: np.ndarray, win_length: int, hop_length: int) -> np.ndarray:
    """Reflection-pad so snip_edges=True framing of the padded signal equals
    Kaldi ``snip_edges=False`` fbank of the original (reference
    ``Inference_X_ASR_ONNX.py:204-217``)."""
    pad = win_length // 2 - hop_length // 2
    rev = waveform[::-1]
    if pad > 0:
        return np.concatenate([rev[-pad:], waveform, rev])
    return np.concatenate([waveform[-pad:], rev])


class XasrStreamingSession:
    """X-ASR Zipformer2 chunked transcription (reference
    ``Inference_X_ASR_ONNX.py:399-433``): snip_edges=False padding, 0.3 s
    tail padding, fixed windows, per-chunk greedy transducer."""

    def __init__(self, params, cfg, tokenizer=None):
        from asr_jax.models import zipformer as zf

        self.zf = zf
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.reset()

    def reset(self) -> None:
        self.state = self.zf.init_state(self.cfg)
        self.token_ids: list[int] = []
        self.elapsed = 0.0

    def transcribe(self, audio: np.ndarray | str | Path) -> TranscribeResult:
        cfg = self.cfg
        if isinstance(audio, (str, Path)):
            audio = audio_io.load_audio(audio, cfg.fbank.sample_rate)
        audio = np.asarray(audio, np.float32)
        n_orig = len(audio)
        fb = cfg.fbank
        padded = snip_edges_false_pad(audio, fb.win_length, fb.hop_length)
        padded = np.concatenate([padded, np.zeros(int(0.3 * fb.sample_rate), np.float32)])
        self.reset()
        w, adv = cfg.window_samples, cfg.advance_samples
        pos = 0
        while pos + w <= len(padded) or pos == 0:
            window = np.zeros(w, np.float32)
            chunk = padded[pos : pos + w]
            window[: len(chunk)] = chunk
            t0 = time.perf_counter()
            self.state, ids, count = self.zf.transcribe_chunk(
                self.params, cfg, self.state, jnp.asarray(window)
            )
            jax.block_until_ready(ids)
            self.elapsed += time.perf_counter() - t0
            self.token_ids.extend(int(t) for t in np.asarray(ids)[: int(count)])
            pos += adv
        text = self.tokenizer.decode(self.token_ids) if self.tokenizer else ""
        return TranscribeResult(
            text=text,
            token_ids=list(self.token_ids),
            audio_seconds=n_orig / fb.sample_rate,
            elapsed_seconds=self.elapsed,
        )


class NemotronStreamingSession:
    """Nemotron cache-aware streaming RNN-T (reference
    ``Inference_Nemotron_ASR_ONNX.py`` streaming path): fixed audio windows,
    carried mel/attention/conv caches + predictor LSTM state, language tag
    stripped from the final text."""

    def __init__(self, params, cfg, tokenizer=None, prompt_id: int = 0,
                 max_new_per_chunk: int = 32):
        from asr_jax.streaming import nemotron_stream as ns

        self.ns = ns
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.prompt_id = prompt_id
        self.max_new = max_new_per_chunk
        # Hoist the per-layer position-key projection out of the chunk step
        # (params-only constant; ≈27% of per-chunk FLOPs at full geometry).
        self.rel_k_cache = ns.precompute_rel_k(params, cfg)
        self.reset()

    def reset(self) -> None:
        blank = self.cfg.base.blank_id
        self.state = {**self.ns.init_state(self.cfg),
                      "token": jnp.asarray([blank], jnp.int32)}
        self.token_ids: list[int] = []
        self.elapsed = 0.0
        self.audio_samples = 0

    def push_chunk(self, chunk: np.ndarray) -> list[int]:
        assert len(chunk) == self.cfg.window_samples, "fixed-size windows required"
        t0 = time.perf_counter()
        pid = jnp.asarray([self.prompt_id], jnp.int32)
        self.state, enc_proj = self.ns.encoder_step(
            self.params, self.cfg, self.state, jnp.asarray(chunk, jnp.float32)[None], pid,
            self.rel_k_cache,
        )
        self.state, ids, count = self.ns.rnnt_stream_step(
            self.params, self.cfg, self.state, enc_proj, max_new=self.max_new
        )
        new_ids = [int(t) for t in np.asarray(ids)[0, : int(count)]]
        self.token_ids.extend(new_ids)
        self.elapsed += time.perf_counter() - t0
        self.audio_samples += len(chunk)
        return new_ids

    def transcribe(self, audio: np.ndarray | str | Path) -> TranscribeResult:
        from asr_jax.runtime.transducer_session import strip_language_tags

        if isinstance(audio, (str, Path)):
            audio = audio_io.load_audio(audio, self.cfg.base.sample_rate, pcm_scale=1.0)
        audio = np.asarray(audio, np.float32)
        self.reset()
        w = self.cfg.window_samples
        n = len(audio)
        for i in range(-(-n // w)):
            chunk = np.zeros(w, np.float32)
            part = audio[i * w : (i + 1) * w]
            chunk[: len(part)] = part
            self.push_chunk(chunk)
        text = strip_language_tags(self.tokenizer.decode(self.token_ids)) if self.tokenizer else ""
        return TranscribeResult(text=text, token_ids=list(self.token_ids),
                                audio_seconds=n / self.cfg.base.sample_rate,
                                elapsed_seconds=self.elapsed)


class DolphinStreamingSession:
    """Dolphin CN-dialect streaming (reference
    ``Export_Dolphin_CN_Dialect_Streaming.py`` + its driver): overlapped
    windows (3 mel frames lookahead), per-chunk CTC partials, and a final AR
    rescoring pass over the accumulated cross-K/V with lang/region probes."""

    def __init__(self, params, cfg, tokenizer=None, decode_cfg=None,
                 language_id: int = -1, region_id: int = -2, blank_id: int = 0,
                 language_catalog: dict | None = None,
                 language: str | None = None):
        from asr_jax.decode.ar import DecodeConfig
        from asr_jax.streaming import dolphin_stream as ds

        self.ds = ds
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.decode_cfg = decode_cfg or DecodeConfig(
            max_new_tokens=min(64, cfg.base.max_target_positions - 4),
            eot_id=cfg.base.eos_id, strategy="greedy")
        if language:
            # same named 2-level resolution as the offline DolphinSession
            from asr_jax.runtime.transducer_session import DolphinSession

            resolver = DolphinSession.__new__(DolphinSession)
            resolver.language_catalog = language_catalog or {}
            language_id, region_id = resolver.resolve_language(language)
        self.language_id = language_id
        self.region_id = region_id
        self.blank_id = blank_id
        # Hoist the per-layer position-key projection out of the chunk step
        # (params-only constant; ~60% of per-chunk FLOPs at full geometry).
        self.rel_k_cache = ds.precompute_rel_k(params, cfg)
        self.reset()

    def reset(self) -> None:
        self.state = self.ds.init_state(self.cfg)
        self.partial_ids: list[int] = []
        self._last_ctc = self.blank_id
        self.elapsed = 0.0

    def push_window(self, window: np.ndarray) -> list[int]:
        """One overlapped window -> newly collapsed CTC partial ids."""
        assert len(window) == self.cfg.window_samples, "fixed-size windows required"
        t0 = time.perf_counter()
        self.state, ctc_ids, _ = self.ds.encoder_step(
            self.params, self.cfg, self.state, jnp.asarray(window, jnp.float32),
            self.rel_k_cache,
        )
        new: list[int] = []
        for t in np.asarray(ctc_ids)[0]:
            t = int(t)
            if t != self.blank_id and t != self._last_ctc:
                new.append(t)
            self._last_ctc = t
        self.partial_ids.extend(new)
        self.elapsed += time.perf_counter() - t0
        return new

    def finalize(self, rng=None) -> list[int]:
        """AR rescoring over everything streamed so far (the reference's
        final decode over the accumulated cross-KV)."""
        t0 = time.perf_counter()
        prompt = jnp.asarray(
            [[self.cfg.base.sos_id, self.language_id, self.region_id]], jnp.int32
        )
        tokens, counts = self.ds.rescore_decode(
            self.params, self.cfg, self.state, prompt, self.decode_cfg, rng
        )
        self.elapsed += time.perf_counter() - t0
        p_len = 3
        return [int(t) for t in np.asarray(tokens)[0, p_len : p_len + int(counts[0])]
                if t != self.cfg.base.eos_id]

    def transcribe(self, audio: np.ndarray | str | Path) -> TranscribeResult:
        if isinstance(audio, (str, Path)):
            audio = audio_io.load_audio(audio, self.cfg.base.sample_rate)
        audio = np.asarray(audio, np.float32)
        self.reset()
        n = len(audio)
        w, adv = self.cfg.window_samples, self.cfg.advance_samples
        pos = 0
        while pos + adv <= n or pos == 0:
            window = np.zeros(w, np.float32)
            part = audio[pos : pos + w]
            window[: len(part)] = part
            self.push_window(window)
            pos += adv
        ids = self.finalize()
        text = self.tokenizer.decode(ids) if self.tokenizer else ""
        return TranscribeResult(text=text, token_ids=ids,
                                audio_seconds=n / self.cfg.base.sample_rate,
                                elapsed_seconds=self.elapsed)
