"""Qwen3-ASR session: prompt assembly + context/hot-word support.

Runtime parity with reference ``Qwen_ASR/Inference_Qwen_ASR_ONNX.py``: the
chat-style prompt [system/head | user context text | suffix | audio |
tail] is tokenized on host (hot words / context biasing go into the user
text, ``:106-127``), the audio window is padded to the tower's
chunk-window multiple, and one device call runs probe-free
prefill+decode (Qwen has no language probe — language comes from the
context prompt or the model itself).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from asr_jax.decode.ar import DecodeConfig
from asr_jax.models import qwen_asr as qa
from asr_jax.runtime import audio as audio_io
from asr_jax.runtime.session import TranscribeResult


@dataclasses.dataclass
class QwenPromptTemplate:
    """Token-id templates around the audio (loader fills from the chat
    template / special tokens of the checkpoint)."""

    head_ids: tuple[int, ...] = ()      # e.g. <|im_start|>system...<|im_start|>user
    suffix_ids: tuple[int, ...] = ()    # between context text and audio
    tail_ids: tuple[int, ...] = ()      # e.g. <|im_end|><|im_start|>assistant


ASR_TEXT_TAG = "<asr_text>"
LANG_PREFIX = "language "


def parse_asr_output(raw: str, user_language: str | None = None) -> tuple[str, str]:
    """Split a decoded "language English<asr_text>hello" string into
    (language, text) — reference ``Inference_Qwen_ASR_ONNX.py:106-123``."""
    text = (raw or "").strip()
    if not text:
        return "", ""
    if user_language:
        return user_language, text
    if ASR_TEXT_TAG not in text:
        return "", text
    meta_part, text_part = text.split(ASR_TEXT_TAG, 1)
    language = ""
    index = meta_part.lower().find(LANG_PREFIX)
    if index >= 0:
        language = meta_part[index + len(LANG_PREFIX):].strip()
        if language:
            language = language[:1].upper() + language[1:].lower()
    return language, text_part.strip()


def _batched_llm_call(items, *, max_samples, sample_rate, pcm_scale, run, eot_id):
    """Shared body of every batched LLM transcribe path: load/truncate,
    zero-pad into one (B, W) buffer, run ``run(audio, valid, b) ->
    (tokens, counts, starts)``, slice each row's generated region and
    filter the EOT. Returns (ids_per_row, valid, elapsed, b)."""
    arrs = []
    for a in items:
        if isinstance(a, (str, Path)):
            a = audio_io.load_audio(a, sample_rate, pcm_scale=pcm_scale)
        arrs.append(np.asarray(a, np.float32)[:max_samples])
    b = len(arrs)
    buf = np.zeros((b, max_samples), np.float32)
    valid = np.zeros((b,), np.int32)
    for i, a in enumerate(arrs):
        buf[i, : len(a)] = a
        valid[i] = len(a)
    t0 = time.perf_counter()
    tokens, counts, starts = run(jnp.asarray(buf), jnp.asarray(valid), b)
    tokens = np.asarray(jax.block_until_ready(tokens))
    counts = np.asarray(counts)
    elapsed = time.perf_counter() - t0
    ids_rows = []
    for i in range(b):
        v, c = int(starts[i]), int(counts[i])
        ids_rows.append([int(t) for t in tokens[i, v : v + c] if t != eot_id])
    return ids_rows, valid, elapsed, b


class QwenAsrSession:
    def __init__(
        self,
        tower_params,
        llm_params,
        cfg: qa.QwenAsrConfig,
        tokenizer=None,
        template: QwenPromptTemplate | None = None,
        max_new_tokens: int = 256,
        strategy: str = "greedy",
        penalty: float = 1.0,
        top_k: int = 0,
        top_p: float = 1.0,
        max_seconds: float = 30.0,
        language_prompt_ids: dict[str, list[int]] | None = None,
        metadata=None,
        mesh=None,
        fuse: bool = True,
    ):
        if fuse:
            # qkv / gate+up fusion: 7 -> 4 matmuls per layer, bit-exact
            # (block quantization is per output column)
            from asr_jax.layers.qwen3 import fuse_params

            llm_params = fuse_params(llm_params, cfg.llm)
        self.runner = None
        if mesh is not None:
            # Batch-DP over ``data`` + Megatron TP of the LLM decoder over
            # ``model`` (qwen3_param_specs); the audio tower replicates —
            # it is ~2% of the weights and its windows batch well.
            from asr_jax.parallel.mesh import qwen3_param_specs, replicated
            from asr_jax.parallel.serve import DataParallelRunner

            self.runner = DataParallelRunner(mesh, param_specs=qwen3_param_specs)
            tower_params = jax.device_put(tower_params, replicated(mesh))
            llm_params = self.runner.shard_params(llm_params)
        self.tower_params = tower_params
        self.llm_params = llm_params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.template = template or QwenPromptTemplate()
        self.decode_cfg = DecodeConfig(
            max_new_tokens=max_new_tokens, eot_id=cfg.eot_id, strategy=strategy,
            penalty=penalty, top_k=top_k, top_p=top_p,
        )
        self.max_samples = int(max_seconds * cfg.sample_rate)
        # code -> prompt token ids ("English<asr_text>" etc.); appending them
        # to the tail forces the output language (reference
        # ``Inference_Qwen_ASR_ONNX.py:522-539`` language tail embeds).
        self.language_prompt_ids = language_prompt_ids or {}
        # Optional ModelMetadata: lets users write any declared alias/name
        # ("Chinese", "mandarin", "中文" -> "zh"), like the reference's
        # ``ORT_IO.resolve_supported_language``.
        self.metadata = metadata
        self.last_language: str = ""
        self.last_languages: list[str] = []

    def _resolve_language_code(self, language: str) -> str:
        code = language.strip().lower()
        if code not in self.language_prompt_ids and self.metadata is not None:
            try:
                code = self.metadata.resolve_language(language).code.lower()
            except KeyError:
                pass  # fall through to the catalog KeyError below
        return code

    def _prompt_ids(self, context: str, language: str | None = None) -> dict:
        query = self.tokenizer.encode(context) if (context and self.tokenizer) else []
        tail = list(self.template.tail_ids)
        if language:
            lang_ids = self.language_prompt_ids.get(self._resolve_language_code(language))
            if lang_ids is None:
                raise KeyError(
                    f"language {language!r} not in this artifact's prompt catalog "
                    f"({sorted(self.language_prompt_ids) or 'empty'})"
                )
            tail = tail + list(lang_ids)
        mk = lambda ids: jnp.asarray([list(ids) or [0]][0], jnp.int32)[None] if ids else jnp.zeros((1, 0), jnp.int32)
        return {
            "head": mk(self.template.head_ids),
            "query": mk(tuple(query)),
            "suffix": mk(self.template.suffix_ids),
            "tail": mk(tuple(tail)),
        }

    def transcribe(
        self, audio: np.ndarray | str | Path, context: str = "",
        language: str | None = None, rng=None
    ) -> TranscribeResult:
        """``context``: optional text prompt (hot words / domain biasing);
        ``language``: force the output language via the artifact's prompt
        catalog (None = model auto-detects; the detected name lands in
        ``self.last_language``)."""
        res = self.transcribe_batch([audio], context=context, language=language,
                                    rng=rng)[0]
        self.last_language = self.last_languages[0]
        return res

    def transcribe_batch(
        self, items, context: str = "", language: str | None = None, rng=None
    ) -> list[TranscribeResult]:
        """N audio files/arrays -> ONE batched prefill + lockstep decode.

        Unequal durations are exact (prompts are re-packed left-padded
        inside ``transcribe_embeds``); batching amortizes the per-step
        weight streaming that bounds AR decode. The reference's ORT loop is
        strictly batch-1.
        Per-row detected languages land in ``self.last_languages``.
        """
        prompt = self._prompt_ids(context, language)

        def run(audio, valid, b):
            if self.runner is not None:
                # DP (batch over data axis) x TP (llm params sharded over
                # model axis); prompt rows tile to the runner's padded batch.
                return self.runner(
                    lambda p, a, v: qa.forward(
                        p[0], p[1], self.cfg, a, v,
                        {k: jnp.tile(val, (a.shape[0], 1)) for k, val in prompt.items()},
                        self.decode_cfg, rng),
                    (self.tower_params, self.llm_params), audio, valid,
                )
            ids_d = {k: jnp.tile(v, (b, 1)) for k, v in prompt.items()}
            return qa.forward(self.tower_params, self.llm_params, self.cfg,
                              audio, valid, ids_d, self.decode_cfg, rng)

        ids_rows, valid, elapsed, b = _batched_llm_call(
            items, max_samples=self.max_samples, sample_rate=self.cfg.sample_rate,
            pcm_scale=1.0, run=run, eot_id=self.cfg.eot_id)
        out, langs = [], []
        for i, ids in enumerate(ids_rows):
            raw = self.tokenizer.decode(ids) if self.tokenizer else ""
            lang, text = parse_asr_output(raw, user_language=language)
            langs.append(lang)
            out.append(TranscribeResult(
                text=text, token_ids=ids,
                audio_seconds=float(valid[i]) / self.cfg.sample_rate,
                elapsed_seconds=elapsed,      # true latency of the shared call
                batch_size=b,
            ))
        self.last_languages = langs
        return out

    # ---- continuous-batching serving surface (parallel/llm_server.py) ----

    _embed_jit = None

    def prompt_embeds(self, samples, context: str = "", language: str | None = None):
        """One request's prompt embeds for continuous batching: (L, H)
        device array (valid prefix + END padding) + valid length. The
        audio pads to ``max_samples`` so every request shares ONE compiled
        tower executable."""
        if self._embed_jit is None:
            self._embed_jit = jax.jit(qa.prompt_embeds, static_argnames=("cfg",))
        s = np.asarray(samples, np.float32)[: self.max_samples]
        buf = np.zeros((1, self.max_samples), np.float32)
        buf[: , : len(s)] = s
        prompt = self._prompt_ids(context, language)
        embeds, valid = self._embed_jit(
            self.tower_params, self.llm_params, cfg=self.cfg,
            audio=jnp.asarray(buf),
            valid_samples=jnp.asarray([len(s)], jnp.int32), prompt_ids=prompt)
        return embeds[0], int(valid[0])

    @property
    def llm_cfg(self):
        return self.cfg.llm

    # ---- micro-batched HTTP serving surface (parallel/http_server.py) ----

    @property
    def params(self):
        return (self.tower_params, self.llm_params)

    @property
    def window_samples(self) -> int:
        return self.max_samples

    @property
    def sample_rate(self) -> int:
        return self.cfg.sample_rate

    pcm_scale = 1.0  # tower consumes [-1, 1] PCM
    # each window's decode carries its own "language X<asr_text>" prefix;
    # the HTTP server must decode+strip per window (see SessionServer)
    postprocess_per_window = True

    def _forward(self, params, audio, valid, language=None):
        """(B, W) audio -> (generated tokens (B, max_new+1), counts (B,));
        the generated region starts at a STATIC offset (left-padded
        lockstep decode), so the per-request slice is ``row[:count]``.
        ``language`` forces the output language via the artifact's prompt
        catalog (the server forwards ``serve --language`` here)."""
        tower, llm = params
        ids_d = {k: jnp.tile(v, (audio.shape[0], 1))
                 for k, v in self._prompt_ids("", language).items()}
        tokens, counts, _ = qa.forward(
            tower, llm, self.cfg, audio, valid, ids_d, self.decode_cfg, None)
        lf = tokens.shape[1] - self.decode_cfg.max_new_tokens - 1
        gen = tokens[:, lf:]
        # counts include the EOT when produced — drop it so the server's
        # row[:count] slice decodes clean text.
        last = jnp.take_along_axis(
            gen, jnp.maximum(counts - 1, 0)[:, None].astype(jnp.int32), axis=1)[:, 0]
        counts = counts - (last == self.cfg.eot_id).astype(counts.dtype)
        return gen, counts

    def _postprocess(self, raw: str) -> str:
        return parse_asr_output(raw)[1]


class FunAsrNanoLlmSession:
    """Fun-ASR-Nano LLM decode path (reference
    ``Fun_ASR_Nano/Inference_Fun_ASR_Nano_ONNX.py`` LLM branch): SANM
    encoder audio tokens spliced into a Qwen3 chat prompt
    [head | context text | audio | tail], one device call for
    prefill+decode. Shares the prompt-template convention with
    :class:`QwenAsrSession` (the reference reuses its Qwen3 shells)."""

    def __init__(
        self,
        params,
        llm_params,
        cfg,
        tokenizer=None,
        template: QwenPromptTemplate | None = None,
        max_new_tokens: int = 256,
        strategy: str = "greedy",
        penalty: float = 1.0,
        top_k: int = 0,
        top_p: float = 1.0,
        max_seconds: float = 30.0,
        mesh=None,
        fuse: bool = True,
    ):
        if fuse:
            from asr_jax.layers.qwen3 import fuse_params

            llm_params = fuse_params(llm_params, cfg.llm)
        self.runner = None
        if mesh is not None:
            # Same DPxTP layout as QwenAsrSession: the Qwen3 LLM shards by
            # qwen3_param_specs, the SANM encoder replicates.
            from asr_jax.parallel.mesh import qwen3_param_specs, replicated
            from asr_jax.parallel.serve import DataParallelRunner

            self.runner = DataParallelRunner(mesh, param_specs=qwen3_param_specs)
            params = jax.device_put(params, replicated(mesh))
            llm_params = self.runner.shard_params(llm_params)
        self.params = params
        self.llm_params = llm_params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.template = template or QwenPromptTemplate()
        self.decode_cfg = DecodeConfig(
            max_new_tokens=max_new_tokens, eot_id=cfg.eot_id, strategy=strategy,
            penalty=penalty, top_k=top_k, top_p=top_p,
        )
        self.max_samples = int(max_seconds * cfg.sample_rate)

    def _prompt_ids(self, context: str) -> dict:
        query = self.tokenizer.encode(context) if (context and self.tokenizer) else []
        mk = lambda ids: (jnp.asarray([list(ids)], jnp.int32)
                          if ids else jnp.zeros((1, 0), jnp.int32))
        # head/suffix collapse into one pre-audio segment for this family
        return {
            "head": mk(tuple(self.template.head_ids)),
            "query": mk(tuple(query) + tuple(self.template.suffix_ids)),
            "tail": mk(tuple(self.template.tail_ids)),
        }

    # ---- continuous-batching serving surface (parallel/llm_server.py) ----

    _embed_jit = None
    pcm_scale = 32768.0  # SANM front-end consumes int16-range PCM

    @property
    def window_samples(self) -> int:
        return self.max_samples

    @property
    def sample_rate(self) -> int:
        return self.cfg.sample_rate

    @property
    def llm_cfg(self):
        return self.cfg.llm

    def prompt_embeds(self, samples, context: str = "", language: str | None = None):
        """One request's prompt embeds for continuous batching — same
        contract as :meth:`QwenAsrSession.prompt_embeds` (``language`` is
        accepted for interface parity; this family has no language
        prompt)."""
        from asr_jax.models import fun_asr_nano as fn

        if language:
            raise KeyError("Fun-ASR-Nano has no language prompt catalog")
        if self._embed_jit is None:
            self._embed_jit = jax.jit(fn.prompt_embeds_llm, static_argnames=("cfg",))
        s = np.asarray(samples, np.float32)[: self.max_samples]
        buf = np.zeros((1, self.max_samples), np.float32)
        buf[:, : len(s)] = s
        prompt = self._prompt_ids(context)
        embeds, valid = self._embed_jit(
            self.params, self.llm_params, cfg=self.cfg,
            audio=jnp.asarray(buf),
            valid_samples=jnp.asarray([len(s)], jnp.int32), prompt_ids=prompt)
        return embeds[0], int(valid[0])

    def transcribe(self, audio, context: str = "", rng=None) -> TranscribeResult:
        return self.transcribe_batch([audio], context=context, rng=rng)[0]

    def transcribe_batch(self, items, context: str = "", rng=None) -> list[TranscribeResult]:
        """N audio files/arrays -> ONE batched prefill + lockstep decode
        (same machinery as :meth:`QwenAsrSession.transcribe_batch`)."""
        from asr_jax.models import fun_asr_nano as fn

        prompt = self._prompt_ids(context)

        def run(audio, valid, b):
            if self.runner is not None:
                return self.runner(
                    lambda p, a, v: fn.forward_llm(
                        p[0], p[1], self.cfg, a, v,
                        {k: jnp.tile(val, (a.shape[0], 1)) for k, val in prompt.items()},
                        self.decode_cfg, rng),
                    (self.params, self.llm_params), audio, valid,
                )
            ids_d = {k: jnp.tile(v, (b, 1)) for k, v in prompt.items()}
            return fn.forward_llm(self.params, self.llm_params, self.cfg,
                                  audio, valid, ids_d, self.decode_cfg, rng)

        ids_rows, valid, elapsed, b = _batched_llm_call(
            items, max_samples=self.max_samples, sample_rate=self.cfg.sample_rate,
            pcm_scale=32768.0, run=run, eot_id=self.cfg.eot_id)
        return [
            TranscribeResult(
                text=self.tokenizer.decode(ids) if self.tokenizer else "",
                token_ids=ids,
                audio_seconds=float(valid[i]) / self.cfg.sample_rate,
                elapsed_seconds=elapsed,      # true latency of the shared call
                batch_size=b,
            )
            for i, ids in enumerate(ids_rows)
        ]
