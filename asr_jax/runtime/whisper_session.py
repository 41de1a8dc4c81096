"""Whisper inference session: file/array -> text with 30 s windows.

Runtime parity with reference ``Whisper/Inference_Whisper_ONNX.py``:
30-second zero-padded windows, per-window probe (language detect +
no-speech), prompt assembly [SOT, lang, task, notimestamps], suppress /
begin-suppress biasing, greedy / penalty / sampling decode, repeat-part
removal and RTF reporting — with the whole per-window pipeline as one
device call.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from asr_jax.decode.ar import DecodeConfig
from asr_jax.models import whisper as wh
from asr_jax.runtime import audio as audio_io
from asr_jax.runtime.session import TranscribeResult, bucket_windows

WINDOW_SECONDS = 30.0


def remove_repeated_tail(ids: list[int], min_rep: int = 2, max_span: int = 20) -> list[int]:
    """Drop a trailing immediate repetition (reference
    ``Whisper/Inference_Whisper_ONNX.py:129-139`` repeat-part removal)."""
    n = len(ids)
    for span in range(1, min(max_span, n // 2) + 1):
        reps = 1
        while (reps + 1) * span <= n and ids[n - (reps + 1) * span : n - reps * span] == ids[n - span :]:
            reps += 1
        if reps >= min_rep + 1:
            return ids[: n - (reps - 1) * span]
    return ids


@dataclasses.dataclass
class WhisperSessionConfig:
    language: str | None = None          # None -> auto-detect per window
    task: str = "transcribe"
    max_new_tokens: int = 440
    strategy: str = "greedy"
    penalty: float = 1.0
    penalty_range: int = 64
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    no_speech_threshold: float | None = 0.6
    suppress_ids: tuple[int, ...] = ()
    begin_suppress_ids: tuple[int, ...] = ()
    # Reference REMOVE_REPEATED_PARTS (``Inference_Whisper_ONNX.py:80``,
    # default False): strip a repeating tail span from each window's ids.
    remove_repeats: bool = False


class WhisperSession:
    pcm_scale = 1.0  # [-1, 1] PCM convention (serving ingest divides int16)

    def __init__(
        self,
        params,
        cfg: wh.WhisperConfig,
        tokenizer=None,
        session_cfg: WhisperSessionConfig | None = None,
        language_id_map: dict[str, int] | None = None,
        mesh=None,
        window_seconds: float = WINDOW_SECONDS,
        param_specs=None,
    ):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.scfg = session_cfg or WhisperSessionConfig()
        self.window_samples = int(window_seconds * cfg.sample_rate)
        self.language_id_map = language_id_map or {}
        self.runner = None
        if mesh is not None:
            from asr_jax.parallel.serve import DataParallelRunner

            self.runner = DataParallelRunner(mesh, param_specs=param_specs)
            params = self.runner.shard_params(params)
        self.params = params
    @property
    def sample_rate(self) -> int:
        return self.cfg.sample_rate

    @property
    def decode_cfg(self) -> DecodeConfig:
        return self._decode_cfg()

    # ---- continuous-batching serving surface (parallel/llm_server.py) ----

    def aed_engine_spec(self):
        from asr_jax.parallel.aed_batcher import spec_for_whisper

        return spec_for_whisper(self.cfg)

    def continuous_prefill(self, samples: np.ndarray,
                           language: str | None = None) -> dict:
        """One request's prefilled decode state for the continuous AED
        engine: encoder + [SOT] probe + prompt prefill for one window
        (``models/whisper.prefill_window``). ``skip=True`` marks a
        no-speech window — the server returns empty ids without admitting
        (the solo path decodes then discards,
        ``WhisperSession.transcribe``; skipping is output-equivalent and
        saves the decode)."""
        s = np.asarray(samples, np.float32)[: self.window_samples]
        buf = np.zeros((1, self.window_samples), np.float32)
        buf[0, : len(s)] = s
        prompt = self._prompt(1, language)
        mel = wh.mel_for_audio(self.cfg, jnp.asarray(buf))
        pre = wh.prefill_window(
            self.params, self.cfg, mel, jnp.asarray(prompt), self.decode_cfg,
            begin_suppress_ids=self.scfg.begin_suppress_ids)
        thresh = self.scfg.no_speech_threshold
        skip = bool(thresh is not None
                    and float(pre["no_speech_prob"][0]) > thresh)
        tc = pre["state"]["layers"][0]["cross_k"].shape[1]
        return {"state": pre["state"], "p_len": prompt.shape[1],
                "logits0": pre["logits0"], "tc_valid": tc, "skip": skip}

    def _decode_cfg(self) -> DecodeConfig:
        s = self.scfg
        return DecodeConfig(
            max_new_tokens=s.max_new_tokens,
            eot_id=self.cfg.eot_id,
            suppress_ids=s.suppress_ids,
            strategy=s.strategy,
            penalty=s.penalty,
            penalty_range=s.penalty_range,
            temperature=s.temperature,
            top_k=s.top_k,
            top_p=s.top_p,
        )

    def _prompt(self, batch: int, language: str | None = None) -> np.ndarray:
        cfg, s = self.cfg, self.scfg
        language = language if language is not None else s.language
        if language is None:
            lang = -1  # auto-detect per window
        elif language in self.language_id_map:
            lang = self.language_id_map[language]
        else:
            raise KeyError(
                f"language {language!r} not in this artifact's language_id_map "
                f"({sorted(self.language_id_map) or 'empty — artifact has no lang_to_id'}); "
                "omit --language for auto-detection"
            )
        task = cfg.transcribe_id if s.task == "transcribe" else cfg.translate_id
        row = [cfg.sot_id, lang, task, cfg.no_timestamps_id]
        return np.tile(np.asarray(row, np.int32), (batch, 1))

    def transcribe(
        self, audio: np.ndarray | str | Path, language: str | None = None, rng=None
    ) -> TranscribeResult:
        if isinstance(audio, (str, Path)):
            audio = audio_io.load_audio(audio, self.cfg.sample_rate, pcm_scale=1.0)
        audio = np.asarray(audio, np.float32)
        n = len(audio)
        w = self.window_samples
        starts = audio_io.iter_windows(n, w, w)  # shared geometry definition
        num_windows = len(starts)
        padded = bucket_windows(num_windows)  # compile once per bucket
        buf = np.zeros((padded, w), np.float32)
        for i, s in enumerate(starts):
            chunk = audio[s : s + w]
            buf[i, : len(chunk)] = chunk

        t0 = time.perf_counter()
        decode_cfg = self._decode_cfg()
        begin_suppress = self.scfg.begin_suppress_ids
        prompt = self._prompt(padded, language)
        if self.runner is not None:
            # Batch-DP over the mesh's data axis: mel + full window pipeline
            # run SPMD with replicated params.
            out = self.runner(
                lambda p, a, pr: wh.transcribe_window(
                    p, self.cfg, wh.mel_for_audio(self.cfg, a), pr, decode_cfg,
                    begin_suppress_ids=begin_suppress, rng=rng,
                ),
                self.params, buf, prompt,
            )
        else:
            mel = wh.mel_for_audio(self.cfg, jnp.asarray(buf))
            out = wh.transcribe_window(
                self.params,
                self.cfg,
                mel,
                jnp.asarray(prompt),
                decode_cfg,
                begin_suppress_ids=begin_suppress,
                rng=rng,
            )
        tokens = np.asarray(jax.block_until_ready(out["tokens"]))
        counts = np.asarray(out["counts"])
        nsp = np.asarray(out["no_speech_prob"])
        elapsed = time.perf_counter() - t0

        p_len = 4
        ids: list[int] = []
        for i in range(num_windows):
            if self.scfg.no_speech_threshold is not None and nsp[i] > self.scfg.no_speech_threshold:
                continue
            win_ids = [int(t) for t in tokens[i, p_len : p_len + counts[i]] if t != self.cfg.eot_id]
            ids.extend(remove_repeated_tail(win_ids) if self.scfg.remove_repeats else win_ids)
        text = self.tokenizer.decode(ids) if self.tokenizer is not None else ""
        return TranscribeResult(
            text=text, token_ids=ids, audio_seconds=n / self.cfg.sample_rate, elapsed_seconds=elapsed
        )
