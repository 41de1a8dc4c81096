"""Command-line interface: transcribe / quantize / inspect model artifacts.

The reference drives everything through per-family scripts with edit-me
constants (``SenseVoice/Inference_SenseVoice_ONNX.py:44-46`` "CLI options
are intentionally limited... Edit this section"); here a single CLI covers
the common operations over self-describing artifact folders.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path


def _build_session(folder: Path, language: str | None = None, mesh=None,
                   dtype: str | None = None, tensor_parallel: int = 1):
    """Artifact folder -> ready session, for every family (the reference's
    per-family inference scripts collapsed into one dispatch).

    ``mesh``: optional jax.sharding.Mesh — offline (windowed) sessions run
    batch-data-parallel over its ``data`` axis (parallel/serve.py).
    ``tensor_parallel``: when > 1, the mesh's ``model`` axis additionally
    shards the family's wide matmuls (Megatron layout, see
    ``parallel.mesh.*_param_specs``) — wired for sensevoice / whisper /
    qwen_asr / fun_asr_nano_llm.
    ``dtype``: serving cast, e.g. "bfloat16" — halves weight HBM; norms and
    softmax stay f32 inside the models (the bf16 replacement for the
    reference's F16 guard machinery, SURVEY.md §7.7)."""
    from asr_jax.runtime.artifact import load_model
    from asr_jax.runtime.metadata import config_from_dict

    params, meta = load_model(folder)
    if dtype:
        from asr_jax.quant.quantize import cast_pytree

        params = cast_pytree(params, dtype)
    family = meta.family
    tokenizer = _build_tokenizer(folder, meta)
    cfg_dict = meta.extra.get("config", {})

    tp = int(tensor_parallel or 1)
    if tp > 1 and family not in ("sensevoice", "whisper", "qwen_asr",
                                 "fun_asr_nano_llm"):
        raise SystemExit(
            f"--tensor-parallel has no sharding specs for family {family!r} "
            "(wired: sensevoice, whisper, qwen_asr, fun_asr_nano_llm)")

    if family == "sensevoice":
        from asr_jax.models.sensevoice import SenseVoiceConfig
        from asr_jax.runtime.session import SenseVoiceSession

        specs = None
        if tp > 1:
            from asr_jax.parallel.mesh import sensevoice_param_specs
            specs = sensevoice_param_specs
        cfg = config_from_dict(SenseVoiceConfig, cfg_dict)
        return SenseVoiceSession(params, cfg, tokenizer=tokenizer, metadata=meta,
                                 mesh=mesh, param_specs=specs)

    if family == "whisper":
        from asr_jax.models.whisper import WhisperConfig
        from asr_jax.runtime.whisper_session import WhisperSession, WhisperSessionConfig

        cfg = config_from_dict(WhisperConfig, cfg_dict)
        scfg = WhisperSessionConfig(
            suppress_ids=tuple(meta.extra.get("suppress_tokens", [])),
            begin_suppress_ids=tuple(meta.extra.get("begin_suppress_tokens", [])),
        )
        lang_map = {p.code: p.prompt_token_id for p in meta.supported_languages
                    if p.prompt_token_id is not None}
        specs = None
        if tp > 1:
            from asr_jax.parallel.mesh import whisper_param_specs
            specs = whisper_param_specs
        return WhisperSession(params, cfg, tokenizer=tokenizer,
                              session_cfg=scfg, language_id_map=lang_map, mesh=mesh,
                              param_specs=specs)

    if family == "paraformer":
        from asr_jax.models.paraformer import ParaformerConfig
        from asr_jax.runtime.transducer_session import ParaformerSession

        cfg = config_from_dict(ParaformerConfig, cfg_dict)
        return ParaformerSession(params, cfg, tokenizer=tokenizer, mesh=mesh)

    if family == "paraformer_streaming":
        from asr_jax.models.paraformer import ParaformerConfig
        from asr_jax.streaming.paraformer_online import ParaformerStreamConfig
        from asr_jax.runtime.streaming_session import ParaformerStreamingSession

        # Artifacts may store the full stream config ({"base": ...}) or just
        # the base model config.
        if "base" in cfg_dict:
            scfg = config_from_dict(ParaformerStreamConfig, cfg_dict)
        else:
            scfg = ParaformerStreamConfig(base=config_from_dict(ParaformerConfig, cfg_dict))
        return ParaformerStreamingSession(params, scfg, tokenizer=tokenizer)

    if family == "parakeet":
        from asr_jax.models.parakeet import ParakeetConfig
        from asr_jax.runtime.transducer_session import ParakeetSession

        cfg = config_from_dict(ParakeetConfig, cfg_dict)
        return ParakeetSession(params, cfg, tokenizer=tokenizer, mesh=mesh)

    if family == "nemotron":
        from asr_jax.models.nemotron import NemotronConfig
        from asr_jax.runtime.transducer_session import NemotronSession

        cfg = config_from_dict(NemotronConfig, cfg_dict)
        prompt_id = 0
        if language:
            prof = meta.resolve_language(language)
            prompt_id = prof.prompt_token_id if prof.prompt_token_id is not None else (prof.index or 0)
        return NemotronSession(params, cfg, tokenizer=tokenizer, prompt_id=prompt_id, mesh=mesh)

    if family == "nemotron_streaming":
        from asr_jax.models.nemotron import NemotronConfig
        from asr_jax.streaming.nemotron_stream import NemotronStreamConfig
        from asr_jax.runtime.streaming_session import NemotronStreamingSession

        if "base" in cfg_dict:
            scfg = config_from_dict(NemotronStreamConfig, cfg_dict)
        else:
            scfg = NemotronStreamConfig(base=config_from_dict(NemotronConfig, cfg_dict))
        prompt_id = 0
        if language:
            prof = meta.resolve_language(language)
            prompt_id = prof.prompt_token_id if prof.prompt_token_id is not None else (prof.index or 0)
        return NemotronStreamingSession(params, scfg, tokenizer=tokenizer, prompt_id=prompt_id)

    if family == "dolphin_streaming":
        from asr_jax.models.dolphin import DolphinConfig
        from asr_jax.streaming.dolphin_stream import DolphinStreamConfig
        from asr_jax.runtime.streaming_session import DolphinStreamingSession

        if "base" in cfg_dict:
            scfg = config_from_dict(DolphinStreamConfig, cfg_dict)
        else:
            scfg = DolphinStreamConfig(base=config_from_dict(DolphinConfig, cfg_dict))
        return DolphinStreamingSession(
            params, scfg, tokenizer=tokenizer,
            language_catalog=meta.extra.get("dolphin_language_catalog") or {},
            language=language)

    if family == "firered":
        from asr_jax.models.firered import FireRedConfig
        from asr_jax.runtime.transducer_session import FireRedSession

        cfg = config_from_dict(FireRedConfig, cfg_dict)
        return FireRedSession(params, cfg, tokenizer=tokenizer, mesh=mesh)

    if family == "dolphin":
        from asr_jax.models.dolphin import DolphinConfig
        from asr_jax.runtime.transducer_session import DolphinSession

        cfg = config_from_dict(DolphinConfig, cfg_dict)
        return DolphinSession(
            params, cfg, tokenizer=tokenizer, mesh=mesh,
            language_catalog=meta.extra.get("dolphin_language_catalog") or {},
            language=language,
        )

    if family == "fun_asr_nano":
        from asr_jax.models.fun_asr_nano import FunAsrNanoConfig
        from asr_jax.runtime.transducer_session import FunAsrNanoCtcSession

        cfg = config_from_dict(FunAsrNanoConfig, cfg_dict)
        return FunAsrNanoCtcSession(params, cfg, tokenizer=tokenizer, mesh=mesh)

    if family == "fun_asr_nano_llm":
        from asr_jax.models.fun_asr_nano import FunAsrNanoConfig
        from asr_jax.runtime.qwen_session import FunAsrNanoLlmSession, QwenPromptTemplate

        cfg = config_from_dict(FunAsrNanoConfig, cfg_dict)
        tpl = QwenPromptTemplate(
            head_ids=tuple(meta.extra.get("prompt_head_ids", [])),
            suffix_ids=tuple(meta.extra.get("prompt_suffix_ids", [])),
            tail_ids=tuple(meta.extra.get("prompt_tail_ids", [])),
        )
        return FunAsrNanoLlmSession(params["encoder"], params["llm"], cfg,
                                    tokenizer=tokenizer, template=tpl, mesh=mesh)

    if family in ("x_asr", "zipformer"):
        from asr_jax.models.zipformer import ZipformerConfig
        from asr_jax.runtime.streaming_session import XasrStreamingSession

        cfg = config_from_dict(ZipformerConfig, cfg_dict)
        return XasrStreamingSession(params, cfg, tokenizer=tokenizer)

    if family == "qwen_asr":
        from asr_jax.models.qwen_asr import QwenAsrConfig
        from asr_jax.runtime.qwen_session import QwenAsrSession, QwenPromptTemplate

        cfg = config_from_dict(QwenAsrConfig, cfg_dict)
        tpl = QwenPromptTemplate(
            head_ids=tuple(meta.extra.get("prompt_head_ids", [])),
            suffix_ids=tuple(meta.extra.get("prompt_suffix_ids", [])),
            tail_ids=tuple(meta.extra.get("prompt_tail_ids", [])),
        )
        return QwenAsrSession(
            params["tower"], params["llm"], cfg, tokenizer=tokenizer, template=tpl,
            language_prompt_ids=meta.extra.get("language_prompt_ids") or {},
            metadata=meta, mesh=mesh,
        )

    if family == "qwen_aligner":
        from asr_jax.models.forced_aligner import ForcedAlignerConfig
        from asr_jax.runtime.aligner_session import QwenAlignerSession

        cfg = config_from_dict(ForcedAlignerConfig, cfg_dict)
        return QwenAlignerSession(
            params["tower"], params["llm"], params["head"], cfg,
            tokenizer=tokenizer, special_ids=meta.special_token_ids,
            tokens_per_word=int(meta.extra.get("timestamp_tokens_per_word", 1)),
        )

    raise SystemExit(f"no session wired for family {family!r} yet; "
                     f"use the python API (asr_jax.models.{family})")


def _build_tokenizer(folder: Path, meta):
    kind = meta.tokenizer.get("kind", "")
    file = meta.tokenizer.get("file", "")
    path = folder / file if file else None
    if not path or not path.exists():
        return None
    from asr_jax.runtime import tokenizer as tok

    if kind == "sentencepiece":
        return tok.SentencePieceDecoder(path)
    if kind == "vocab_txt":
        return tok.VocabTxtDecoder(path, meta.extra.get("decode_mode", "zh"))
    if kind == "hf":
        return tok.HFTokenizerDecoder(path)
    if kind == "json":
        return tok.JsonVocabDecoder(path)
    if kind == "firered_dict":
        return tok.FireRedDictDecoder(path)
    if kind == "tiktoken":
        return tok.TiktokenVocabDecoder(path)
    return None


def _mesh_from_args(args):
    """(data_parallel, tensor_parallel) flags -> Mesh or None."""
    dp = getattr(args, "data_parallel", 0) or 0
    tp = getattr(args, "tensor_parallel", 1) or 1
    if not dp and tp <= 1:
        return None, 1
    from asr_jax.parallel.mesh import make_mesh

    n = dp * tp if dp else None  # dp unset: all devices / tp
    return make_mesh(n, model_parallel=tp), tp


def cmd_transcribe(args) -> int:
    mesh, tp = _mesh_from_args(args)
    sess = _build_session(Path(args.model_dir), language=args.language, mesh=mesh,
                          dtype=getattr(args, "dtype", None), tensor_parallel=tp)
    if mesh is not None and getattr(sess, "runner", None) is None:
        raise SystemExit(
            f"--data-parallel/--tensor-parallel is not wired for "
            f"{type(sess).__name__}; rerun without it"
        )
    import contextlib
    import inspect

    profile_ctx = contextlib.nullcontext()
    if args.profile:
        from asr_jax.runtime.profiling import trace

        profile_ctx = trace(args.profile)
    with profile_ctx:
        if len(args.audio) > 1 and hasattr(sess, "transcribe_batch"):
            # many files -> one batched device dispatch (native parallel ingest)
            kwargs = {}
            if args.language and "language" in inspect.signature(sess.transcribe_batch).parameters:
                kwargs["language"] = args.language
            for audio, res in zip(args.audio, sess.transcribe_batch(args.audio, **kwargs)):
                print(f"{audio}\t({res.audio_seconds:.2f}s, RTF {res.rtf:.4f})")
                print(res.text if res.text else res.token_ids)
        else:
            for audio in args.audio:
                kwargs = {}
                if args.language and "language" in inspect.signature(sess.transcribe).parameters:
                    kwargs["language"] = args.language
                res = sess.transcribe(audio, **kwargs)
                print(f"{audio}\t({res.audio_seconds:.2f}s, RTF {res.rtf:.4f})")
                print(res.text if res.text else res.token_ids)
    if args.profile:
        print(f"device trace written to {args.profile} (view: tensorboard --logdir)")
    return 0


def cmd_inspect(args) -> int:
    from asr_jax.runtime.metadata import ModelMetadata
    from asr_jax.runtime.artifact import WEIGHTS_FILENAME

    folder = Path(args.model_dir)
    meta = ModelMetadata.load(folder)
    print(json.dumps({
        "family": meta.family,
        "sample_rate": meta.sample_rate,
        "audio_pcm_scale": meta.audio_pcm_scale,
        "special_token_ids": meta.special_token_ids,
        "languages": [p.code for p in meta.supported_languages],
        "weights_bytes": (folder / WEIGHTS_FILENAME).stat().st_size,
    }, indent=2))
    return 0


def cmd_quantize(args) -> int:
    from asr_jax.quant.quantize import quantize_pytree
    from asr_jax.runtime.artifact import load_model, save_model

    params, meta = load_model(Path(args.model_dir))
    if args.reorder:
        from asr_jax.quant.reorder import channel_reorder_pytree

        params, n = channel_reorder_pytree(params, stat=args.reorder)
        print(f"reordered {n} FFN pairs by {args.reorder}")
    qparams = quantize_pytree(params, bits=args.bits, block=args.block,
                              refine_iters=args.refine_iters, pack=args.pack,
                              objective=args.algorithm, min_size=args.min_size,
                              quantize_embeddings=args.quantize_embeddings)
    if args.algorithm == "dynamic" and (args.bits != 8 or args.pack):
        print("note: --algorithm dynamic is always 8-bit per-column, unpacked "
              "(activations quantize at call time); --bits/--pack ignored")
    # Record what was actually applied (dynamic forces 8-bit, unpacked,
    # per-COLUMN scales — the CLI --block value does not apply to it).
    dyn = args.algorithm == "dynamic"
    bits = 8 if dyn else args.bits
    meta.extra["quantization"] = {
        "bits": bits,
        "block": "per_column" if dyn else args.block,
        "algorithm": args.algorithm,
    }
    save_model(Path(args.out), qparams, meta)
    _copy_artifact_assets(Path(args.model_dir), Path(args.out), meta)
    blk = "per-column" if dyn else f"block {args.block}"
    print(f"quantized ({bits}-bit {args.algorithm}, {blk}) -> {args.out}")
    return 0


def _copy_artifact_assets(src: Path, dst: Path, meta) -> None:
    """Carry EVERY companion asset (tokenizer/vocab/spm/yaml) into a derived
    artifact — not just the primary tokenizer file; e.g. FireRed artifacts
    ship dict.txt + the encode-side train_bpe1000.model (the reference
    copies all assets into every optimized folder,
    ``SenseVoice/Export_SenseVoice.py:415-421``)."""
    import shutil

    skip = {"weights.safetensors", "metadata.json"}
    for f in src.iterdir():
        if f.is_file() and f.name not in skip and not (dst / f.name).exists():
            shutil.copy2(f, dst / f.name)


def cmd_align(args) -> int:
    sess = _build_session(Path(args.model_dir))
    if not hasattr(sess, "align"):
        raise SystemExit("model artifact is not a forced-aligner family")
    for item in sess.align(args.audio, args.text, language=args.language):
        print(f"{item['start_ms']:>8d} {item['end_ms']:>8d}  {item['text']}")
    return 0


def cmd_optimize(args) -> int:
    from asr_jax.quant.plan import OptimizerConfig, apply_plans
    from asr_jax.runtime.artifact import load_model, save_model

    cfg = OptimizerConfig.load(args.plan)
    params, meta = load_model(Path(args.model_dir))
    qparams = apply_plans(params, cfg)
    meta.extra["optimizer_plan"] = json.loads(Path(args.plan).read_text(encoding="utf-8"))
    save_model(Path(args.out), qparams, meta)
    _copy_artifact_assets(Path(args.model_dir), Path(args.out), meta)
    print(f"applied plan {args.plan} -> {args.out}")
    return 0


def cmd_build(args) -> int:
    """Checkpoint dir/file -> artifact folder (the reference's Export_*.py
    entry points as one subcommand)."""
    from asr_jax import export as ex

    family = args.family
    src, out = args.checkpoint, args.out
    if family == "sensevoice":
        ex.build_sensevoice_artifact(src, out)
    elif family == "whisper":
        ex.build_whisper_artifact(src, out)
    elif family in ("paraformer", "paraformer_streaming"):
        ex.build_paraformer_artifact(
            src, out, decode_mode=args.decode_mode,
            streaming=family.endswith("streaming") or args.streaming,
        )
    elif family in ("dolphin", "dolphin_streaming"):
        ex.build_dolphin_artifact(
            src, out, vocab_path=args.vocab,
            streaming=family.endswith("streaming") or args.streaming,
        )
    elif family in ("nemotron", "nemotron_streaming"):
        ex.build_nemotron_artifact(
            src, out, streaming=family.endswith("streaming") or args.streaming,
        )
    elif family in ("x_asr", "zipformer"):
        ex.build_xasr_artifact(src, out, bpe_model=args.vocab)
    elif family == "parakeet":
        ex.build_parakeet_artifact(src, out)
    elif family == "firered":
        ex.build_firered_artifact(src, out)
    elif family == "qwen_asr":
        ex.build_qwen_asr_artifact(src, out)
    elif family == "qwen_aligner":
        ex.build_qwen_aligner_artifact(src, out)
    elif family in ("fun_asr_nano", "fun_asr_nano_llm"):
        ex.build_fun_asr_nano_artifact(
            src, out, head="llm" if family.endswith("llm") else "ctc"
        )
    else:
        raise SystemExit(f"no builder wired for family {family!r}")
    print(f"built {family} artifact -> {out}")
    return 0


def cmd_parity(args) -> int:
    """One-command correctness harness (BASELINE.md gate: token-for-token
    transcripts vs the ONNX reference on Test_Examples). Run the moment a
    real checkpoint is available:

      asr_jax parity --model-dir M                    # print transcripts
      asr_jax parity --model-dir M --save-golden G    # capture goldens
      asr_jax parity --model-dir M --golden G         # compare (rc!=0 on drift)

    Goldens are JSON {fixture: {"language","text","token_ids"}}; capture
    them from the reference's Inference_*.py output (text match) or a prior
    run of this framework (regression match).
    """
    # Token-for-token gate: quantized artifacts must run the kernels'
    # bit-exact f32 mode, not the bf16 serving default (env is read at
    # trace time, so set it before the session's first jit). Overrides any
    # inherited serving value — parity is meaningless in bf16 mode.
    # Restored on exit: a lingering f32 override would silently disable
    # bf16-gated kernel routing for the rest of the process (bit us in
    # same-process test runs).
    prior_mm = os.environ.get("ASR_JAX_QUANT_MM")
    os.environ["ASR_JAX_QUANT_MM"] = "f32"
    try:
        return _cmd_parity_impl(args)
    finally:
        if prior_mm is None:
            os.environ.pop("ASR_JAX_QUANT_MM", None)
        else:
            os.environ["ASR_JAX_QUANT_MM"] = prior_mm


def _cmd_parity_impl(args) -> int:
    from asr_jax.runtime.examples import model_audio_cases
    from asr_jax.runtime.metadata import ModelMetadata
    from asr_jax.runtime.probe import capture_probe, compare_probes

    meta = ModelMetadata.load(Path(args.model_dir))
    sess = _build_session(Path(args.model_dir))
    import inspect

    cases = model_audio_cases(args.family or meta.family,
                              Path(args.examples) if args.examples else None)
    if not cases:
        raise SystemExit(f"no registered fixtures for family {meta.family!r}")
    # --save-golden wins when both flags name the same (possibly not yet
    # existing) file: capture mode never reads --golden.
    golden = (json.loads(Path(args.golden).read_text())
              if args.golden and not args.save_golden else None)
    # Versioned golden schema: v2 wraps the per-fixture dict as
    # {"golden_schema": 2, "fixtures": {...}} so future fields never
    # collide with fixture names; v1 goldens (a bare fixture dict) stay
    # readable forever.
    if golden is not None and "golden_schema" in golden:
        golden = golden["fixtures"]
    # Stage probes (runtime/probe.py) ride the goldens: captured with
    # --save-golden, recomputed on compare only when the golden carries
    # them, so old transcript-only goldens keep working.
    want_probes = args.save_golden or (
        golden is not None and any("probe" in w for w in golden.values()))
    results = {}
    for lang, path in cases:
        kwargs = {}
        if "language" in inspect.signature(sess.transcribe).parameters:
            kwargs["language"] = lang
        res = sess.transcribe(str(path), **kwargs)
        results[path.name] = {"language": lang, "text": res.text,
                              "token_ids": res.token_ids}
        if want_probes:
            probe = capture_probe(sess, str(path))
            if probe is not None:
                results[path.name]["probe"] = probe
        print(f"{path.name}\t[{lang}]\tRTF {res.rtf:.4f}\t{res.text}")
    if args.save_golden:
        Path(args.save_golden).write_text(json.dumps(
            {"golden_schema": 2, "fixtures": results},
            ensure_ascii=False, indent=2))
        print(f"goldens captured -> {args.save_golden}")
        return 0
    if golden is not None:
        failures = []
        for name, want in golden.items():
            got = results.get(name)
            if got is None:
                failures.append(f"{name}: fixture missing from run")
                continue
            # Probe drift first: it names the first drifting STAGE, which
            # localizes any transcript mismatch to front-end/encoder/decode.
            for msg in compare_probes(got.get("probe"), want.get("probe")):
                failures.append(f"{name}: {msg}")
            if want.get("token_ids") and got["token_ids"] != want["token_ids"]:
                failures.append(f"{name}: token ids drifted")
            elif got["text"] != want["text"]:
                failures.append(f"{name}: text {got['text']!r} != {want['text']!r}")
        if failures:
            print("PARITY FAIL:\n  " + "\n  ".join(failures))
            return 1
        print(f"PARITY OK: {len(golden)} fixtures token-for-token")
    return 0


def cmd_bench(args) -> int:
    """Run the per-family RTF matrix (tools/bench_matrix.py) — measures every
    family at real checkpoint geometry on the GPU and prints one JSON record
    per family."""
    import importlib.util

    tool = Path(__file__).resolve().parent.parent / "tools" / "bench_matrix.py"
    if not tool.exists():
        raise SystemExit(f"bench matrix tool not found: {tool}")
    spec = importlib.util.spec_from_file_location("bench_matrix", tool)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    import sys as _sys

    argv, _sys.argv = _sys.argv, [str(tool)] + list(args.families)
    try:
        return mod.main()
    finally:
        _sys.argv = argv


def cmd_serve(args) -> int:
    """HTTP serving: micro-batched transcription endpoint (the production
    counterpart of the reference's per-file script loop)."""
    continuous = getattr(args, "continuous", False)
    if continuous:
        # --continuous scales out replica-per-group (llm_server.py): the
        # session itself stays unsharded; --data-parallel N builds N
        # batcher replicas behind one admission queue, and
        # --tensor-parallel T gives each replica a T-device sub-mesh
        # (GSPMD Megatron step inside the batcher).
        mesh, tp = None, 1
    else:
        mesh, tp = _mesh_from_args(args)
    sess = _build_session(Path(args.model_dir), language=args.language, mesh=mesh,
                          tensor_parallel=tp)
    if continuous:
        if not (hasattr(sess, "prompt_embeds")
                or hasattr(sess, "continuous_prefill")):
            raise SystemExit(
                f"--continuous serves the LLM families (qwen_asr, "
                f"fun_asr_nano --head llm) and the AED families (whisper, "
                f"firered, dolphin); {type(sess).__name__} has neither "
                "surface — rerun without --continuous")
        from asr_jax.parallel.llm_server import serve_continuous

        serve_continuous(sess, host=args.host, port=args.port,
                         n_slots=args.slots, language=args.language,
                         context=args.context, kv_dtype=args.kv_dtype,
                         data_parallel=max(getattr(args, "data_parallel", 0) or 1, 1),
                         steps_per_tick=max(getattr(args, "steps_per_tick", 0) or 1, 1),
                         tensor_parallel=max(
                             getattr(args, "tensor_parallel", 0) or 1, 1))
        return 0
    if not hasattr(sess, "_forward"):
        raise SystemExit(f"family {type(sess).__name__} has no batchable "
                         "window forward; serve supports the offline (windowed) "
                         "and LLM (Qwen3-ASR) families")
    if mesh is not None and getattr(sess, "runner", None) is None:
        raise SystemExit(
            f"--data-parallel/--tensor-parallel is not wired for "
            f"{type(sess).__name__}; rerun without it"
        )
    from asr_jax.parallel.http_server import serve_forever

    serve_forever(sess, host=args.host, port=args.port,
                  max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                  language=args.language)
    return 0


def cmd_serve_stream(args) -> int:
    """Real-time streaming endpoint: N concurrent chunked-HTTP connections
    -> one vmapped device step per tick (parallel/stream_server.py)."""
    from pathlib import Path as _P

    import numpy as np

    from asr_jax.runtime.artifact import load_model
    from asr_jax.runtime.metadata import config_from_dict
    from asr_jax.parallel.stream_server import serve_streams
    from asr_jax.streaming import multistream as ms

    params, meta = load_model(_P(args.model_dir))
    family = meta.family
    cfg_dict = meta.extra.get("config", {})
    n = args.streams
    extract = None
    advance = None
    pcm_scale = 32768.0
    tail_pad = 0
    drain_min = 1

    if family == "paraformer_streaming":
        from asr_jax.models.paraformer import ParaformerConfig
        from asr_jax.streaming.paraformer_online import ParaformerStreamConfig

        scfg = (config_from_dict(ParaformerStreamConfig, cfg_dict)
                if "base" in cfg_dict else
                ParaformerStreamConfig(base=config_from_dict(ParaformerConfig, cfg_dict)))
        runner = ms.paraformer_multistream(params, scfg, n)
        chunk = scfg.chunk_samples
    elif family == "nemotron_streaming":
        from asr_jax.models.nemotron import NemotronConfig
        from asr_jax.streaming.nemotron_stream import NemotronStreamConfig

        scfg = (config_from_dict(NemotronStreamConfig, cfg_dict)
                if "base" in cfg_dict else
                NemotronStreamConfig(base=config_from_dict(NemotronConfig, cfg_dict)))
        runner = ms.nemotron_multistream(params, scfg, n)
        chunk = scfg.window_samples
        pcm_scale = 1.0  # NeMo mel consumes [-1, 1] PCM
    elif family in ("x_asr", "zipformer"):
        from asr_jax.models.zipformer import ZipformerConfig

        cfg = config_from_dict(ZipformerConfig, cfg_dict)
        runner = ms.zipformer_multistream(params, cfg, n)
        chunk, advance = cfg.window_samples, cfg.advance_samples
        # session behavior: 0.3 s zero tail; stop once a full window no
        # longer fits (the file-mode snip-edges FRONT pad needs lookahead a
        # live stream does not have and is not applied)
        tail_pad = int(0.3 * 16000)
        drain_min = chunk
    elif family == "dolphin_streaming":
        from asr_jax.models.dolphin import DolphinConfig
        from asr_jax.streaming.dolphin_stream import DolphinStreamConfig

        scfg = (config_from_dict(DolphinStreamConfig, cfg_dict)
                if "base" in cfg_dict else
                DolphinStreamConfig(base=config_from_dict(DolphinConfig, cfg_dict)))
        runner = ms.dolphin_multistream(params, scfg, n)
        chunk, advance = scfg.window_samples, scfg.advance_samples
        drain_min = advance  # session fires while pos + adv <= n
        blank = 0

        def extract(outs, i, st):  # per-slot cross-chunk CTC collapse
            prev = st.get("last", blank)
            new = []
            for t in np.asarray(outs["ctc_ids"][i]):
                t = int(t)
                if t != blank and t != prev:
                    new.append(t)
                prev = t
            st["last"] = prev
            return new
    else:
        raise SystemExit(
            f"serve-stream supports the streaming families "
            f"(paraformer_streaming, nemotron_streaming, x_asr, "
            f"dolphin_streaming); artifact is {family!r}")

    serve_streams(runner, chunk, host=args.host, port=args.port,
                  extract=extract, pcm_scale=pcm_scale,
                  advance_samples=advance, tail_pad_samples=tail_pad,
                  drain_min_samples=drain_min,
                  ticks_per_sync=max(getattr(args, "ticks_per_sync", 0) or 1, 1))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="asr_jax")
    parser.add_argument("--platform", default=None,
                        help="force a jax platform (e.g. cpu, cuda) before any compute")
    parser.add_argument("--quant-mm", default=None, choices=("bf16", "f32"),
                        help="matmul mode for quantized weights: bf16 (serving "
                             "default, one tensor-core pass, f32 accumulation) "
                             "or f32 (exact vs the f32 dequant reference); set "
                             "before any compute, overrides ASR_JAX_QUANT_MM")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("transcribe", help="transcribe audio files with a model artifact")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--language", default=None)
    p.add_argument("--tensor-parallel", type=int, default=1, metavar="T",
                   help="shard the model's wide matmuls over T devices "
                        "(Megatron TP; sensevoice/whisper/qwen_asr/"
                        "fun_asr_nano_llm); composes with --data-parallel "
                        "as a (data, model) mesh")
    p.add_argument("--data-parallel", type=int, default=0, metavar="N",
                   help="shard window batches over an N-device data-parallel "
                        "mesh (0 = single device)")
    p.add_argument("--dtype", default=None, choices=("bfloat16", "float32"),
                   help="serving cast (bfloat16 halves weight HBM; norms/"
                        "softmax stay f32)")
    p.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="capture an xprof device trace of the run into LOGDIR")
    p.add_argument("audio", nargs="+")
    p.set_defaults(fn=cmd_transcribe)

    p = sub.add_parser("align", help="forced-align a transcript against audio (word timestamps)")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--text", required=True, help="transcript to align")
    p.add_argument("--language", default=None,
                   help="unit-splitter language (e.g. japanese); default space/CJK")
    p.add_argument("audio")
    p.set_defaults(fn=cmd_align)

    p = sub.add_parser("inspect", help="print a model artifact's metadata")
    p.add_argument("--model-dir", required=True)
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("quantize", help="weight-only quantize an artifact")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--bits", type=int, default=8, choices=(2, 4, 8))
    p.add_argument("--block", type=int, default=128)
    p.add_argument("--refine-iters", type=int, default=2)
    p.add_argument("--quantize-embeddings", action="store_true",
                   help="also quantize embed tables into gather-dequant "
                        "leaves (LLM-decoder families)")
    p.add_argument("--min-size", type=int, default=1 << 16,
                   help="skip linear weights with fewer elements than this")
    p.add_argument("--algorithm", default="rtn", choices=("rtn", "kquant", "hqq", "dynamic"),
                   help="block fit: round-to-nearest or importance-weighted grid search")
    p.add_argument("--pack", action="store_true",
                   help="pack 4-bit weights two-per-byte / 2-bit four-per-byte")
    p.add_argument("--reorder", default=None, choices=("absmean", "rms", "l4", "std"),
                   help="exact-math FFN channel reordering before quantization")
    p.set_defaults(fn=cmd_quantize)

    p = sub.add_parser("optimize", help="apply a declarative serving plan (JSON) to an artifact")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--plan", required=True,
                   help="JSON with {plans: {name: {...}}, assign: [[glob, name], ...]}")
    p.set_defaults(fn=cmd_optimize)

    p = sub.add_parser("parity", help="transcribe registered fixtures; capture/compare goldens")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--family", default=None, help="override the artifact's family for fixture lookup")
    p.add_argument("--examples", default=None, help="Test_Examples root (default: seeded stand-ins, runtime/examples.py)")
    p.add_argument("--golden", default=None, help="compare against a goldens JSON (rc!=0 on drift)")
    p.add_argument("--save-golden", default=None, help="write transcripts as goldens JSON")
    p.set_defaults(fn=cmd_parity)

    p = sub.add_parser("bench", help="per-family RTF benchmark matrix (real geometry, random weights)")
    p.add_argument("families", nargs="*",
                   help="family keys (default: all) — see tools/bench_matrix.py BENCHES")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("serve", help="HTTP transcription endpoint (micro-batched)")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--language", default=None)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--data-parallel", type=int, default=0, metavar="N")
    p.add_argument("--tensor-parallel", type=int, default=1, metavar="T",
                   help="Megatron TP over T devices (see transcribe)")
    p.add_argument("--continuous", action="store_true",
                   help="continuous batching for the LLM families: requests "
                        "join/leave one running decode batch mid-flight "
                        "(parallel/llm_server.py) instead of lockstep "
                        "micro-batches")
    p.add_argument("--slots", type=int, default=8,
                   help="concurrent decode slots for --continuous")
    p.add_argument("--kv-dtype", choices=("f32", "bf16"), default="f32",
                   dest="kv_dtype",
                   help="--continuous KV-cache storage dtype; bf16 halves "
                   "per-step cache traffic (output stays token-identical "
                   "across slot layouts, no longer bitwise vs f32 solo)")
    p.add_argument("--context", default="",
                   help="fixed hot-word/context prompt for --continuous")
    p.add_argument("--steps-per-tick", type=int, default=1,
                   dest="steps_per_tick",
                   help="--continuous decode steps fused per host dispatch "
                   "(lax.scan): K tokens per host sync, token-identical; "
                   "joins/frees land on tick boundaries. Raise when the "
                   "host<->device link is slow relative to the ~1 ms step")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("serve-stream",
                       help="real-time streaming endpoint: N concurrent "
                            "chunked-HTTP PCM connections, one vmapped "
                            "device step per tick")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8001)
    p.add_argument("--streams", type=int, default=8,
                   help="concurrent stream slots (vmapped batch size)")
    p.add_argument("--ticks-per-sync", type=int, default=1,
                   help="chunk ticks fused into ONE device dispatch + host "
                        "sync (lax.scan): a remote-host deployment pays the "
                        "device round trip once per K chunks; results then "
                        "emit in K-chunk batches (token streams identical)")
    p.set_defaults(fn=cmd_serve_stream)

    p = sub.add_parser("build", help="build an artifact folder from a source checkpoint")
    p.add_argument("--family", required=True,
                   choices=("sensevoice", "whisper", "paraformer", "paraformer_streaming",
                            "dolphin", "dolphin_streaming", "x_asr", "zipformer", "parakeet",
                            "firered", "qwen_asr", "qwen_aligner", "fun_asr_nano",
                            "fun_asr_nano_llm", "nemotron", "nemotron_streaming"))
    p.add_argument("--checkpoint", required=True, help="source checkpoint dir or file")
    p.add_argument("--out", required=True)
    p.add_argument("--streaming", action="store_true")
    p.add_argument("--decode-mode", default="zh", choices=("zh", "en"))
    p.add_argument("--vocab", default=None, help="tokenizer/vocab path for families "
                   "whose checkpoint file does not bundle one (dolphin, x_asr)")
    p.set_defaults(fn=cmd_build)

    args = parser.parse_args(argv)
    import os

    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
        import jax

        jax.config.update("jax_platforms", args.platform)
    from asr_jax.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.quant_mm:
        from asr_jax.ops.quant_matmul import set_quant_config

        set_quant_config(mm=args.quant_mm)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
