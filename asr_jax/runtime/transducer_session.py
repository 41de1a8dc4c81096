"""Offline sessions for the transducer / AED families.

Runtime parity with the per-family reference drivers: fixed windows,
batched device calls, tokenizer decode, RTF reporting. Each session wraps
a model-module ``forward`` with the family's PCM convention.
"""

from __future__ import annotations

import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from asr_jax.runtime import audio as audio_io
from asr_jax.runtime.session import TranscribeResult, bucket_windows


def strip_language_tags(text: str) -> str:
    """Drop emitted ``<en>`` / ``<zh-CN>``-style language tags (reference
    ``Nemotron/Inference_Nemotron_ASR_ONNX.py:221-223``)."""
    import re

    return re.sub(r"<[a-z]{2}(-[A-Za-z]{2,4})?>", "", text).strip()


class _WindowedSession:
    """Shared machinery: pad/window audio, run forward per window batch."""

    pcm_scale = 1.0         # 32768.0 = int16 numeric range convention
    window_seconds = 30.0
    sample_rate = 16000

    def __init__(self, params, cfg, tokenizer=None, window_seconds=None, mesh=None,
                 param_specs=None):
        self.cfg = cfg
        self.tokenizer = tokenizer
        if window_seconds is not None:
            self.window_seconds = window_seconds
        self.window_samples = int(self.window_seconds * self.sample_rate)
        self.runner = None
        if mesh is not None:
            from asr_jax.parallel.serve import DataParallelRunner

            self.runner = DataParallelRunner(mesh, param_specs=param_specs)
            params = self.runner.shard_params(params)
        self.params = params

    def _forward(self, params, audio: jnp.ndarray, valid: jnp.ndarray):
        raise NotImplementedError

    def _postprocess(self, text: str) -> str:
        return text

    def transcribe(self, audio: np.ndarray | str | Path, **kw) -> TranscribeResult:
        if isinstance(audio, (str, Path)):
            audio = audio_io.load_audio(audio, self.sample_rate, pcm_scale=self.pcm_scale)
        audio = np.asarray(audio, np.float32)
        n = len(audio)
        w = self.window_samples
        starts = audio_io.iter_windows(n, w, w)  # shared geometry definition
        num = len(starts)
        padded = bucket_windows(num)  # one compiled executable per bucket
        buf = np.zeros((padded, w), np.float32)
        valid = np.zeros((padded,), np.int32)
        for i, s in enumerate(starts):
            chunk = audio[s : s + w]
            buf[i, : len(chunk)] = chunk
            valid[i] = len(chunk)
        t0 = time.perf_counter()
        if self.runner is not None:
            # Batch data-parallel over the mesh's data axis: pads to a
            # device multiple, shards windows, replicated params.
            toks, counts = self.runner(
                lambda p, a, v: self._forward(p, a, v, **kw), self.params, buf, valid
            )
        else:
            toks, counts = self._forward(self.params, jnp.asarray(buf), jnp.asarray(valid), **kw)
        toks = np.asarray(jax.block_until_ready(toks))
        counts = np.asarray(counts)
        elapsed = time.perf_counter() - t0
        ids = [int(t) for i in range(num) for t in toks[i, : counts[i]]]
        text = self._postprocess(self.tokenizer.decode(ids)) if self.tokenizer else ""
        return TranscribeResult(text=text, token_ids=ids,
                                audio_seconds=n / self.sample_rate,
                                elapsed_seconds=elapsed)

    def transcribe_batch(self, paths, n_threads: int = 0, **kw) -> list[TranscribeResult]:
        """Many short files -> ONE device dispatch: the native parallel
        batch loader fills a fixed (N, window) buffer (files longer than one
        window fall back to the per-file sliding-window path). Available on
        every windowed family (reference: per-file script loops)."""
        buf, true_len = audio_io.load_audio_batch(
            paths, self.sample_rate, self.window_samples,
            pcm_scale=self.pcm_scale, n_threads=n_threads,
        )
        valid = np.minimum(true_len, self.window_samples).astype(np.int32)
        t0 = time.perf_counter()
        if self.runner is not None:
            toks, counts = self.runner(
                lambda p, a, v: self._forward(p, a, v, **kw), self.params, buf, valid
            )
        else:
            toks, counts = self._forward(self.params, jnp.asarray(buf), jnp.asarray(valid), **kw)
        toks = np.asarray(jax.block_until_ready(toks))
        counts = np.asarray(counts)
        elapsed = time.perf_counter() - t0
        results = []
        for i, path in enumerate(paths):
            if true_len[i] > self.window_samples:
                results.append(self.transcribe(path, **kw))
                continue
            ids = [int(t) for t in toks[i, : counts[i]]]
            text = self._postprocess(self.tokenizer.decode(ids)) if self.tokenizer else ""
            results.append(TranscribeResult(
                text=text, token_ids=ids,
                audio_seconds=float(valid[i]) / self.sample_rate,
                elapsed_seconds=elapsed, batch_size=len(paths),
            ))
        return results


class ParakeetSession(_WindowedSession):
    """Parakeet-TDT offline (reference ``Inference_Parakeet_ASR_ONNX.py``).
    NeMo convention: [-1, 1] PCM via ``mel.input_scale`` in the config."""

    window_seconds = 24.0   # bounded by the baked PE table (~123 s max)

    def _forward(self, params, audio, valid):
        from asr_jax.models import parakeet as pk

        return pk.forward(params, self.cfg, audio, valid)


class NemotronSession(_WindowedSession):
    """Nemotron offline RNN-T with multilingual prompt id (reference
    ``Inference_Nemotron_ASR_ONNX.py``)."""

    def __init__(self, params, cfg, tokenizer=None, prompt_id: int = 0, **kw):
        super().__init__(params, cfg, tokenizer, **kw)
        self.prompt_id = prompt_id

    def _forward(self, params, audio, valid):
        from asr_jax.models import nemotron as nm

        pid = jnp.full((audio.shape[0],), self.prompt_id, jnp.int32)
        return nm.forward(params, self.cfg, audio, valid, pid)

    def _postprocess(self, text: str) -> str:
        return strip_language_tags(text)


class FireRedSession(_WindowedSession):
    """FireRedASR-AED offline (reference ``Inference_FireRedASR_AED_ONNX.py``);
    Kaldi int16-range convention, AR greedy/penalty/sampling decode."""

    pcm_scale = 32768.0

    def __init__(self, params, cfg, tokenizer=None, decode_cfg=None, **kw):
        super().__init__(params, cfg, tokenizer, **kw)
        from asr_jax.decode.ar import DecodeConfig

        self.decode_cfg = decode_cfg or DecodeConfig(
            max_new_tokens=224, eot_id=cfg.eos_id, strategy="greedy"
        )

    def _forward(self, params, audio, valid):
        from asr_jax.models import firered as fr

        toks, counts = fr.transcribe(params, self.cfg, audio, valid, self.decode_cfg)
        return toks[:, 1:], counts  # drop the SOS slot

    # ---- continuous-batching serving surface (parallel/llm_server.py) ----

    _aed_spec = None

    def aed_engine_spec(self):
        if self._aed_spec is None:
            from asr_jax.parallel.aed_batcher import spec_for_aed

            # static padded cross length for the fixed window — the same
            # arithmetic models/firered.encode_from_mel applies (lookahead
            # pad then two k3/s2 valid convs); computed host-side so server
            # startup pays no encoder dispatch/compile just to size slots
            t = (self.cfg.fbank.num_frames(self.window_samples)
                 + self.cfg.pad_lookahead)
            tc = ((t - 3) // 2 + 1 - 3) // 2 + 1
            self._aed_spec = spec_for_aed(self.cfg, tc)
        return self._aed_spec

    def continuous_prefill(self, samples, language: str | None = None) -> dict:
        from asr_jax.models import firered as fr

        s = np.asarray(samples, np.float32)[: self.window_samples]
        buf = np.zeros((1, self.window_samples), np.float32)
        buf[0, : len(s)] = s
        pre = fr.prefill_window(self.params, self.cfg, jnp.asarray(buf),
                                jnp.asarray([len(s)], np.int32),
                                self.decode_cfg)
        return {"state": pre["state"], "p_len": 1, "logits0": pre["logits0"],
                "tc_valid": int(pre["enc_valid"][0]), "skip": False}


class ParaformerSession(_WindowedSession):
    """Paraformer non-streaming (reference ``Inference_Paraformer_ONNX.py``)."""

    pcm_scale = 32768.0
    window_seconds = 30.0

    def __init__(self, params, cfg, tokenizer=None, max_tokens=256, **kw):
        super().__init__(params, cfg, tokenizer, **kw)
        self.max_tokens = max_tokens

    def _forward(self, params, audio, valid):
        from asr_jax.models import paraformer as pf

        return pf.forward(params, self.cfg, audio, valid, max_tokens=self.max_tokens)


class DolphinSession(_WindowedSession):
    """Dolphin offline AED with language/region auto-probe (reference
    ``Inference_Dolphin_ONNX.py``): prompt [sos, lang, region] where -1/-2
    request the probed language/region token; generated ids start after the
    prompt. Exposes the probed lang/region of the last call."""

    pcm_scale = 32768.0
    window_seconds = 30.0

    def __init__(self, params, cfg, tokenizer=None, decode_cfg=None,
                 language_id: int = -1, region_id: int = -2,
                 language_catalog: dict | None = None,
                 language: str | None = None, **kw):
        super().__init__(params, cfg, tokenizer, **kw)
        from asr_jax.decode.ar import DecodeConfig

        self.decode_cfg = decode_cfg or DecodeConfig(
            max_new_tokens=224, eot_id=cfg.eos_id, strategy="greedy"
        )
        # ``language_catalog``: the artifact's 2-level token catalog
        # (export.dolphin_language_catalog). ``language`` accepts "ja",
        # "Japanese", "zh-SICHUAN" or "Chinese-Sichuan"-style names and
        # resolves to forced prompt token ids; -1/-2 keep auto-probing.
        self.language_catalog = language_catalog or {}
        if language:
            language_id, region_id = self.resolve_language(language)
        self.language_id = language_id
        self.region_id = region_id
        self.last_language: int | None = None
        self.last_region: int | None = None

    def resolve_language(self, name: str) -> tuple[int, int]:
        """Name -> (language_token_id, region_token_id_or_-2).

        Accepts a model code ("ja", "zh-SICHUAN"), an alias ("Japanese"),
        or an Alias-Region compound ("Chinese-Sichuan"). Raises KeyError
        listing the catalog when unresolvable — forcing by name must never
        silently fall back to auto-detection."""
        cat = self.language_catalog
        langs = cat.get("languages") or {}
        regions = cat.get("regions") or {}
        aliases = {k.lower(): v for k, v in (cat.get("aliases") or {}).items()}
        want = name.strip()
        if want.lower() in ("auto", "auto-auto"):
            return -1, -2
        lang_part, _, region_part = want.partition("-")
        code = aliases.get(lang_part.lower(), lang_part.lower())
        if code not in langs:
            raise KeyError(
                f"language {name!r} not in this artifact's catalog "
                f"(languages: {sorted(langs) or 'none — rebuild with --vocab'}; "
                f"aliases: {sorted(cat.get('aliases') or {})})")
        if not region_part or region_part.lower() == "auto":
            return langs[code], -2
        region = region_part.upper()
        if region not in regions:
            raise KeyError(
                f"region {region_part!r} not in this artifact's catalog "
                f"(regions: {sorted(regions)})")
        return langs[code], regions[region]

    def _forward(self, params, audio, valid):
        from asr_jax.models import dolphin as dp

        b = audio.shape[0]
        prompt = np.tile(
            np.array([[self.cfg.sos_id, self.language_id, self.region_id]], np.int32),
            (b, 1),
        )
        out = dp.transcribe(params, self.cfg, audio, valid,
                            jnp.asarray(prompt), self.decode_cfg)
        if "language" in out:
            self.last_language = int(out["language"][0])
        if "region" in out:
            self.last_region = int(out["region"][0])
        p_len = prompt.shape[1]
        return out["tokens"][:, p_len:], out["counts"]

    # ---- continuous-batching serving surface (parallel/llm_server.py) ----

    _aed_spec = None

    def aed_engine_spec(self):
        if self._aed_spec is None:
            from asr_jax.parallel.aed_batcher import spec_for_aed

            # static padded cross length for the fixed window — the same
            # arithmetic models/dolphin.encode_from_mel applies (two k3/s2
            # valid convs over 1 + S // hop mel frames); host-side, so
            # server startup runs no encoder (and no silence probe that
            # would clobber last_language/last_region)
            t = self.cfg.mel.num_frames(self.window_samples)
            tc = ((t - 3) // 2 + 1 - 3) // 2 + 1
            self._aed_spec = spec_for_aed(self.cfg, tc)
        return self._aed_spec

    def continuous_prefill(self, samples, language: str | None = None) -> dict:
        from asr_jax.models import dolphin as dp

        lang_id, region_id = (self.resolve_language(language) if language
                              else (self.language_id, self.region_id))
        s = np.asarray(samples, np.float32)[: self.window_samples]
        buf = np.zeros((1, self.window_samples), np.float32)
        buf[0, : len(s)] = s
        prompt = jnp.asarray([[self.cfg.sos_id, lang_id, region_id]], jnp.int32)
        pre = dp.prefill_window(self.params, self.cfg, jnp.asarray(buf),
                                jnp.asarray([len(s)], np.int32), prompt,
                                self.decode_cfg)
        if "language" in pre:
            self.last_language = int(pre["language"][0])
        if "region" in pre:
            self.last_region = int(pre["region"][0])
        return {"state": pre["state"], "p_len": 3, "logits0": pre["logits0"],
                "tc_valid": int(pre["enc_valid"][0]), "skip": False}


class FunAsrNanoCtcSession(_WindowedSession):
    """Fun-ASR-Nano fast CTC head (reference
    ``Inference_FunASR_Nano_ONNX.py`` CTC branch); Kaldi int16 convention."""

    pcm_scale = 32768.0
    window_seconds = 30.0

    def _forward(self, params, audio, valid):
        from asr_jax.models import fun_asr_nano as fn

        return fn.forward_ctc(params, self.cfg, audio, valid)
