#!/usr/bin/env python
"""Per-family RTF matrix on one GPU — counterpart of the reference's
headline README performance table (its ``README.md:44-64``, CPU numbers).

Each family runs at REAL checkpoint geometry (the config defaults the
loaders target) with random weights — RTF is weight-value-independent
because every decode loop is forced to a fixed step count (``eot_id=-1``
never matches, transducers cap at max_tokens with padded frames), so the
measured work equals the work on a real transcript of that length.

Prints one JSON record per family (device kind and count included) and a
markdown table; exits non-zero without a GPU.

Run: ``python tools/bench_matrix.py [family ...]`` (default: all).
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from asr_jax.runtime.compile_cache import enable_compile_cache

jax.config.update("jax_default_matmul_precision", "highest")

# Dense peaks without sparsity, keyed by ``device_kind``: NVIDIA H100 SXM
# data sheet, at the card's full 700 W power limit. f32 rows run at
# HIGHEST precision, i.e. outside the tensor cores.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_tflops": 989.0, "tf32_tflops": 495.0,
                              "f32_tflops": 67.0, "hbm_gbps": 3350.0},
}


def _peaks() -> dict:
    kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise SystemExit(f"no peak figures for device kind {kind!r}; add its data sheet values")
    return PEAKS[kind]


RESULTS = []


def _audio(batch, seconds, rate=16000, scale=2000.0, seed=0):
    rng = np.random.default_rng(seed)
    s = int(seconds * rate)
    a = jnp.asarray((rng.standard_normal((batch, s)) * scale).astype(np.float32))
    return a, jnp.full((batch,), s, jnp.int32)


def _ceiling(name: str) -> float:
    # quantized / bf16 rows run their matmuls as bf16 tensor-core passes
    pk = _peaks()
    return pk["bf16_tflops"] if any(t in name for t in ("bf16", "q8", "q4", "q2")) \
        else pk["f32_tflops"]


def _device() -> dict:
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}


def _measure(name, fn, args, batch, audio_seconds, iters, ref_cpu_rtf, note="",
             ceiling_tflops=None, analytic_flops_per_iter=None,
             analytic_bytes_per_iter=None):
    if ceiling_tflops is None:
        ceiling_tflops = _ceiling(name)
    t_c0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t_c0
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    elapsed = time.perf_counter() - t0
    rtf = elapsed / (iters * batch * audio_seconds)
    # XLA's own cost model for the compiled executable -> achieved
    # TFLOP/s and share of the peak.
    flops = None
    try:
        ca = fn.lower(*args).compile().cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        flops = float(ca.get("flops", 0.0)) or None
    except Exception:
        pass
    # XLA's cost model does not count while/fori bodies — rows built from
    # those (the continuous-batching steady-state loops) pass an ANALYTIC
    # per-iteration flop count instead.
    if (flops is None or flops / max(analytic_flops_per_iter or 1, 1) < 0.5) \
            and analytic_flops_per_iter:
        flops = float(analytic_flops_per_iter)
    rec = {
        "family": name,
        "rtf": round(rtf, 6),
        "batch": batch,
        "audio_seconds": audio_seconds,
        "iters": iters,
        "compile_s": round(compile_s, 1),
        "ref_cpu_rtf": ref_cpu_rtf,
        "speedup_vs_ref": round(ref_cpu_rtf / rtf, 1) if ref_cpu_rtf else None,
        "note": note,
        "device": _device(),
    }
    if flops:
        achieved = flops * iters / elapsed / 1e12
        # XLA's cost model does not count fori_loop/while_loop bodies —
        # a near-zero figure means "unknown", not "idle": omit the fields.
        if achieved >= 0.05:
            rec["achieved_tflops_per_s"] = round(achieved, 2)
            rec["pct_of_peak_tflops"] = round(100 * achieved / ceiling_tflops, 1)
            rec["peak_tflops"] = ceiling_tflops
    if analytic_bytes_per_iter:
        gbps = analytic_bytes_per_iter * iters / elapsed / 1e9
        rec["achieved_hbm_gbps"] = round(gbps, 1)
        rec["pct_of_peak_hbm"] = round(100 * gbps / _peaks()["hbm_gbps"], 1)
    RESULTS.append(rec)
    print(json.dumps(rec), flush=True)


def _tree_bytes(tree) -> int:
    return sum(l.size * l.dtype.itemsize for l in jax.tree.leaves(tree))


def _aed_step_bytes(dec, nl, d, t_self, t_cross, kv_itemsize) -> int:
    """Analytic per-decode-step device-memory reads of a batch-1 AED step:
    the decoder weights (incl. the tied head) stream once, plus the full
    (static-shape) self-KV cache and the cross-KV planes. Batch-1 latency
    rows are WEIGHT-STREAM-bound (MFU alone reads misleadingly low)."""
    return _tree_bytes(dec) + nl * 2 * (t_self + t_cross) * d * kv_itemsize


def bench_sensevoice():
    from asr_jax.models import sensevoice as sv
    cfg = sv.SenseVoiceConfig()
    params = sv.init_params(cfg, jax.random.PRNGKey(0))
    audio, valid = _audio(8, 8.0)
    lang = jnp.zeros((8,), jnp.int32)
    fn = jax.jit(lambda p, a, v, l: sv.forward(p, cfg, a, v, l))
    _measure("sensevoice_small_f32", fn, (params, audio, valid, lang), 8, 8.0, 20,
             0.019, "reference README.md:52 (best CPU, i3-12300)")


def bench_sensevoice_bf16():
    """bf16 serving config (norms/softmax stay f32 inside the model)."""
    from asr_jax.models import sensevoice as sv
    from asr_jax.quant.quantize import cast_pytree
    cfg = sv.SenseVoiceConfig()
    params = cast_pytree(sv.init_params(cfg, jax.random.PRNGKey(0)), jnp.bfloat16)
    audio, valid = _audio(8, 8.0)
    lang = jnp.zeros((8,), jnp.int32)
    fn = jax.jit(lambda p, a, v, l: sv.forward(p, cfg, a, v, l))
    _measure("sensevoice_small_bf16", fn, (params, audio, valid, lang), 8, 8.0, 20,
             0.019, "bf16 weights/activations (f32 norms); serving ceiling config")


def bench_sensevoice_q8():
    """q8f32 serving config (reference README.md:53: 0.022 on i3-12300)."""
    from asr_jax.models import sensevoice as sv
    from asr_jax.quant.quantize import quantize_pytree
    cfg = sv.SenseVoiceConfig()
    params = quantize_pytree(sv.init_params(cfg, jax.random.PRNGKey(0)), bits=8)
    audio, valid = _audio(8, 8.0)
    lang = jnp.zeros((8,), jnp.int32)
    fn = jax.jit(lambda p, a, v, l: sv.forward(p, cfg, a, v, l))
    _measure("sensevoice_small_q8f32", fn, (params, audio, valid, lang), 8, 8.0, 20,
             0.022, "int8 block-128 weights, XLA dequant + bf16 matmuls")


def bench_whisper(dtype=jnp.float32, tag="f32"):
    from asr_jax.models import whisper as wh
    from asr_jax.decode.ar import DecodeConfig
    cfg = wh.WhisperConfig()  # large-v3-turbo geometry
    params = wh.init_params(cfg, jax.random.PRNGKey(0), dtype=dtype)
    audio, _ = _audio(8, 30.0, scale=0.1)
    mel = wh.mel_for_audio(cfg, audio)
    prompt = jnp.tile(jnp.asarray(
        [[cfg.sot_id, -1, cfg.transcribe_id, cfg.no_timestamps_id]], jnp.int32), (8, 1))
    dc = DecodeConfig(max_new_tokens=200, eot_id=-1)
    fn = jax.jit(lambda p, m, pr: wh.transcribe_window(p, cfg, m, pr, dc))
    _measure(f"whisper_large_v3_turbo_{tag}", fn, (params, mel, prompt), 8, 30.0, 3,
             0.073, "forced 200 decode steps/window; ref README.md:55 q8f32 i3-12300")


def bench_whisper_q8():
    """q8f32 Whisper-Turbo (reference README.md:55: 0.073 on i3-12300)."""
    from asr_jax.models import whisper as wh
    from asr_jax.decode.ar import DecodeConfig
    from asr_jax.quant.quantize import quantize_pytree
    cfg = wh.WhisperConfig()
    params = quantize_pytree(wh.init_params(cfg, jax.random.PRNGKey(0)), bits=8)
    audio, _ = _audio(8, 30.0, scale=0.1)
    mel = wh.mel_for_audio(cfg, audio)
    prompt = jnp.tile(jnp.asarray(
        [[cfg.sot_id, -1, cfg.transcribe_id, cfg.no_timestamps_id]], jnp.int32), (8, 1))
    dc = DecodeConfig(max_new_tokens=200, eot_id=-1)
    fn = jax.jit(lambda p, m, pr: wh.transcribe_window(p, cfg, m, pr, dc))
    _measure("whisper_large_v3_turbo_q8f32", fn, (params, mel, prompt), 8, 30.0, 3,
             0.073, "int8 block-128 weights, forced 200 decode steps; ref README.md:55")


def bench_whisper_q8_bf16():
    """q8 weights + bf16 activations: the fastest Whisper serving config —
    quantized matvecs ride the bf16-mode kernels AND the unquantized
    encoder/attention math runs one-pass bf16 (f32 norms/softmax inside)."""
    from asr_jax.models import whisper as wh
    from asr_jax.decode.ar import DecodeConfig
    from asr_jax.quant.quantize import cast_pytree, quantize_pytree
    cfg = wh.WhisperConfig()
    params = cast_pytree(
        quantize_pytree(wh.init_params(cfg, jax.random.PRNGKey(0)), bits=8), jnp.bfloat16)
    audio, _ = _audio(8, 30.0, scale=0.1)
    mel = wh.mel_for_audio(cfg, audio).astype(jnp.bfloat16)
    prompt = jnp.tile(jnp.asarray(
        [[cfg.sot_id, -1, cfg.transcribe_id, cfg.no_timestamps_id]], jnp.int32), (8, 1))
    dc = DecodeConfig(max_new_tokens=200, eot_id=-1)
    fn = jax.jit(lambda p, m, pr: wh.transcribe_window(p, cfg, m, pr, dc))
    _measure("whisper_large_v3_turbo_q8bf16", fn, (params, mel, prompt), 8, 30.0, 3,
             0.073, "int8 block-128 weights + bf16 activations, forced 200 decode steps")


def bench_whisper_batch1(tag="q8bf16", iters=3):
    """Interactive single-stream Whisper-Turbo: batch 1, the shape the
    reference's own headline number is measured at (its runtime is
    strictly batch-1). q8 weights + bf16 activations."""
    from asr_jax.models import whisper as wh
    from asr_jax.decode.ar import DecodeConfig
    from asr_jax.quant.quantize import cast_pytree, quantize_pytree
    cfg = wh.WhisperConfig()
    params = cast_pytree(
        quantize_pytree(wh.init_params(cfg, jax.random.PRNGKey(0)), bits=8,
                        quantize_embeddings=True), jnp.bfloat16)
    audio, _ = _audio(1, 30.0, scale=0.1)
    mel = wh.mel_for_audio(cfg, audio).astype(jnp.bfloat16)
    prompt = jnp.asarray(
        [[cfg.sot_id, -1, cfg.transcribe_id, cfg.no_timestamps_id]], jnp.int32)
    dc = DecodeConfig(max_new_tokens=200, eot_id=-1)
    fn = jax.jit(lambda p, m, pr: wh.transcribe_window(p, cfg, m, pr, dc))
    # per-iter reads: encoder weights once per 30 s window + 200 decode
    # steps (decoder weights + bf16 self cache (448 rows) + cross-KV (1500)).
    step_b = _aed_step_bytes(params["decoder"], cfg.decoder_layers, cfg.d_model,
                             cfg.max_target_positions, cfg.max_source_positions, 2)
    _measure("whisper_large_v3_turbo_q8bf16_batch1", fn, (params, mel, prompt),
             1, 30.0, iters,
             0.073, "SINGLE-STREAM latency row: batch 1, int8 block-128 weights "
             "+ bf16 activations (incl. q8 tied head), forced 200 decode steps; "
             "ref README.md:55",
             analytic_bytes_per_iter=_tree_bytes(params["encoder"]) + 200 * step_b)


def bench_qwen_asr_q4():
    """q4f32 Qwen3-ASR (reference README.md:62: 0.12 on i7-1165G7).

    Tower is q8 like the reference's Encoder plan
    (``Qwen_ASR/Optimize_ONNX.py:139-144`` method="Q8"): the tower is
    0.63 GB of weights — f32 it costs ~7.6 ms of pure HBM reads per
    8 s window; q8 cuts that 4x (measured 10.9 -> 7.0 ms mel+tower)."""
    from asr_jax.models import qwen_asr as qa
    from asr_jax.layers import qwen3
    from asr_jax.decode.ar import DecodeConfig
    from asr_jax.quant.quantize import quantize_pytree
    cfg = qa.QwenAsrConfig()
    tower = quantize_pytree(qa.init_tower_params(cfg, jax.random.PRNGKey(0)), bits=8)
    llm = qwen3.fuse_params(
        quantize_pytree(qwen3.init_params(cfg.llm, jax.random.PRNGKey(1)),
                        bits=4, pack=True), cfg.llm)
    audio, valid = _audio(1, 8.0, scale=0.1)
    ids = {
        "head": jnp.asarray([[1, 2, 3]], jnp.int32),
        "query": jnp.asarray([[4, 5]], jnp.int32),
        "suffix": jnp.asarray([[6]], jnp.int32),
        "tail": jnp.asarray([[7, 8]], jnp.int32),
    }
    dc = DecodeConfig(max_new_tokens=100, eot_id=-1)
    fn = jax.jit(lambda t, l, a, v: qa.forward(t, l, cfg, a, v, ids, dc))
    # per-iter reads: q8 tower once per window + 100 decode steps (int4
    # layers + f32 head + f32 KV cache, t_max 216 = prompt 112
    # [3+104 audio+2+1+2] + 100 steps + 1, rounded to 8).
    lc = cfg.llm
    step_b = _tree_bytes(llm) + lc.num_layers * 2 * 216 * lc.num_kv_heads * lc.head_dim * 4
    _measure("qwen3_asr_0.6b_q4f32", fn, (tower, llm, audio, valid), 1, 8.0, 10,
             0.12, "packed-int4 LLM weights + q8 tower, forced 100 steps",
             analytic_bytes_per_iter=_tree_bytes(tower) + 100 * step_b)


def bench_paraformer():
    from asr_jax.models import paraformer as pf
    cfg = pf.ParaformerConfig()  # large-zh geometry
    params = pf.init_params(cfg, jax.random.PRNGKey(0))
    audio, valid = _audio(8, 8.0)
    fn = jax.jit(lambda p, a, v: pf.forward(p, cfg, a, v, max_tokens=128))
    _measure("paraformer_large_f32", fn, (params, audio, valid), 8, 8.0, 10,
             0.14, "CIF + non-AR decoder; ref README.md:57 q8f32 i5-7300HQ")


def bench_parakeet():
    from asr_jax.models import parakeet as pk
    cfg = pk.ParakeetConfig()
    params = pk.init_params(cfg, jax.random.PRNGKey(0))
    audio, valid = _audio(8, 8.0, scale=0.1)
    fn = jax.jit(lambda p, a, v: pk.forward(p, cfg, a, v, max_tokens=128))
    _measure("parakeet_tdt_0.6b_f32", fn, (params, audio, valid), 8, 8.0, 5,
             0.08, "TDT greedy over all frames; ref README.md:64 q8f32 i7-1165G7")


def bench_nemotron():
    from asr_jax.models import nemotron as nm
    cfg = nm.NemotronConfig()
    params = nm.init_params(cfg, jax.random.PRNGKey(0))
    audio, valid = _audio(8, 8.0, scale=0.1)
    prompt = jnp.zeros((8,), jnp.int32)
    fn = jax.jit(lambda p, a, v, pr: nm.forward(p, cfg, a, v, pr, max_tokens=128))
    _measure("nemotron_0.6b_f32", fn, (params, audio, valid, prompt), 8, 8.0, 5,
             0.1, "RNN-T greedy; ref README.md:63 q8f32 i7-1165G7")


def bench_firered():
    from asr_jax.models import firered as fr
    from asr_jax.decode.ar import DecodeConfig
    cfg = fr.FireRedConfig()  # AED-L geometry
    params = fr.init_params(cfg, jax.random.PRNGKey(0))
    audio, valid = _audio(8, 8.0)
    dc = DecodeConfig(max_new_tokens=60, eot_id=-1)
    fn = jax.jit(lambda p, a, v: fr.transcribe(p, cfg, a, v, dc))
    _measure("firered_aed_l_f32", fn, (params, audio, valid), 8, 8.0, 5,
             0.17, "forced 60 decode steps; ref README.md:59 q8f32 i3-12300")


def bench_dolphin():
    from asr_jax.models import dolphin as dp
    from asr_jax.decode.ar import DecodeConfig
    cfg = dp.DolphinConfig()  # small geometry
    params = dp.init_params(cfg, jax.random.PRNGKey(0))
    audio, valid = _audio(8, 8.0)
    # [sos, lang(-1 probe), region(-2 probe), task, notimestamps] layout
    prompt = jnp.tile(jnp.asarray([[cfg.sos_id, -1, -2, 5, 6]], jnp.int32), (8, 1))
    dc = DecodeConfig(max_new_tokens=60, eot_id=-1)
    fn = jax.jit(lambda p, a, v, pr: dp.transcribe(p, cfg, a, v, pr, dc))
    _measure("dolphin_small_f32", fn, (params, audio, valid, prompt), 8, 8.0, 5,
             0.14, "forced 60 decode steps; ref README.md:60 q8f32 i7-1165G7")


def bench_firered_q8():
    """q8f32 FireRed — the configuration the reference actually publishes
    (README.md:59); decode matvecs run in the bf16 quantized-matmul mode."""
    from asr_jax.models import firered as fr
    from asr_jax.decode.ar import DecodeConfig
    from asr_jax.quant.quantize import quantize_pytree
    cfg = fr.FireRedConfig()
    params = quantize_pytree(fr.init_params(cfg, jax.random.PRNGKey(0)), bits=8)
    audio, valid = _audio(8, 8.0)
    dc = DecodeConfig(max_new_tokens=60, eot_id=-1)
    fn = jax.jit(lambda p, a, v: fr.transcribe(p, cfg, a, v, dc))
    _measure("firered_aed_l_q8f32", fn, (params, audio, valid), 8, 8.0, 5,
             0.17, "int8 block-128 weights, forced 60 decode steps; ref README.md:59")


def bench_dolphin_q8():
    """q8f32 Dolphin — matches the reference's published config (README.md:60)."""
    from asr_jax.models import dolphin as dp
    from asr_jax.decode.ar import DecodeConfig
    from asr_jax.quant.quantize import quantize_pytree
    cfg = dp.DolphinConfig()
    params = quantize_pytree(dp.init_params(cfg, jax.random.PRNGKey(0)), bits=8)
    audio, valid = _audio(8, 8.0)
    prompt = jnp.tile(jnp.asarray([[cfg.sos_id, -1, -2, 5, 6]], jnp.int32), (8, 1))
    dc = DecodeConfig(max_new_tokens=60, eot_id=-1)
    fn = jax.jit(lambda p, a, v, pr: dp.transcribe(p, cfg, a, v, pr, dc))
    _measure("dolphin_small_q8f32", fn, (params, audio, valid, prompt), 8, 8.0, 5,
             0.14, "int8 block-128 weights, forced 60 decode steps; ref README.md:60")


def bench_firered_q8_batch1():
    """SINGLE-STREAM FireRed-AED-L latency: batch 1, q8 weights — the
    shape the reference's own published number is measured at (its
    runtime is strictly batch-1, ``FireRedASR/Inference_FireRedASR_AED_ONNX.py``);
    16 decoder layers + tied head per step."""
    from asr_jax.models import firered as fr
    from asr_jax.decode.ar import DecodeConfig
    from asr_jax.quant.quantize import quantize_pytree
    cfg = fr.FireRedConfig()
    params = quantize_pytree(fr.init_params(cfg, jax.random.PRNGKey(0)),
                             bits=8, quantize_embeddings=True)
    audio, valid = _audio(1, 8.0)
    dc = DecodeConfig(max_new_tokens=60, eot_id=-1)
    fn = jax.jit(lambda p, a, v: fr.transcribe(p, cfg, a, v, dc))
    # per-iter reads: encoder side once per window + 60 decode steps
    # (decoder weights + f32 self cache + f32 cross-KV (~200 rows @ 8 s)).
    step_b = _aed_step_bytes(params["decoder"], cfg.dec_layers, cfg.d_model,
                             cfg.max_target_positions, 200, 4)
    _measure("firered_aed_l_q8f32_batch1", fn, (params, audio, valid),
             1, 8.0, 5,
             0.17, "SINGLE-STREAM latency row: batch 1, int8 block-128 weights, "
             "forced 60 decode steps; ref README.md:59",
             analytic_bytes_per_iter=(
                 _tree_bytes(params) - _tree_bytes(params["decoder"]) + 60 * step_b))


def bench_dolphin_q8_batch1():
    """SINGLE-STREAM Dolphin-Small latency: batch 1, q8 weights (reference
    README.md:60 config; its runtime is strictly batch-1); 6 decoder
    layers + tied head per step."""
    from asr_jax.models import dolphin as dp
    from asr_jax.decode.ar import DecodeConfig
    from asr_jax.quant.quantize import quantize_pytree
    cfg = dp.DolphinConfig()
    params = quantize_pytree(dp.init_params(cfg, jax.random.PRNGKey(0)),
                             bits=8, quantize_embeddings=True)
    audio, valid = _audio(1, 8.0)
    prompt = jnp.asarray([[cfg.sos_id, -1, -2, 5, 6]], jnp.int32)
    dc = DecodeConfig(max_new_tokens=60, eot_id=-1)
    fn = jax.jit(lambda p, a, v, pr: dp.transcribe(p, cfg, a, v, pr, dc))
    # per-iter reads: encoder side once per window + 60 decode steps
    # (decoder weights + f32 self cache + f32 cross-KV (~200 rows @ 8 s)).
    step_b = _aed_step_bytes(params["decoder"], cfg.dec_layers, cfg.d_model,
                             cfg.max_target_positions, 200, 4)
    _measure("dolphin_small_q8f32_batch1", fn,
             (params, audio, valid, prompt), 1, 8.0, 5,
             0.14, "SINGLE-STREAM latency row: batch 1, int8 block-128 weights, "
             "forced 60 decode steps; ref README.md:60",
             analytic_bytes_per_iter=(
                 _tree_bytes(params) - _tree_bytes(params["decoder"]) + 60 * step_b))


def bench_fun_asr_nano_ctc():
    from asr_jax.models import fun_asr_nano as fn_
    cfg = fn_.FunAsrNanoConfig()
    params = fn_.init_params(cfg, jax.random.PRNGKey(0))
    audio, valid = _audio(8, 8.0)
    fn = jax.jit(lambda p, a, v: fn_.forward_ctc(p, cfg, a, v))
    _measure("fun_asr_nano_ctc_f32", fn, (params, audio, valid), 8, 8.0, 10,
             0.11, "fast CTC head (ref number is the q4f32 LLM path, README.md:61)")


def bench_qwen_asr_q4_qembed():
    """q4 weights + quantized tied embed/LM head: the head is the single
    biggest HBM read of each decode step (151936 x 1024 f32 = 622 MB).
    Tower q8 (reference Encoder plan, ``Qwen_ASR/Optimize_ONNX.py:139``)."""
    from asr_jax.models import qwen_asr as qa
    from asr_jax.layers import qwen3
    from asr_jax.decode.ar import DecodeConfig
    from asr_jax.quant.quantize import quantize_pytree
    cfg = qa.QwenAsrConfig()
    tower = quantize_pytree(qa.init_tower_params(cfg, jax.random.PRNGKey(0)), bits=8)
    llm = qwen3.fuse_params(
        quantize_pytree(qwen3.init_params(cfg.llm, jax.random.PRNGKey(1)),
                        bits=4, pack=True, quantize_embeddings=True), cfg.llm)
    audio, valid = _audio(1, 8.0, scale=0.1)
    ids = {
        "head": jnp.asarray([[1, 2, 3]], jnp.int32),
        "query": jnp.asarray([[4, 5]], jnp.int32),
        "suffix": jnp.asarray([[6]], jnp.int32),
        "tail": jnp.asarray([[7, 8]], jnp.int32),
    }
    dc = DecodeConfig(max_new_tokens=100, eot_id=-1)
    fn = jax.jit(lambda t, l, a, v: qa.forward(t, l, cfg, a, v, ids, dc))
    # per-iter reads: same shape as the q4f32 row but the tied head
    # streams int4 instead of f32.
    lc = cfg.llm
    step_b = _tree_bytes(llm) + lc.num_layers * 2 * 216 * lc.num_kv_heads * lc.head_dim * 4
    _measure("qwen3_asr_0.6b_q4f32_qembed", fn, (tower, llm, audio, valid), 1, 8.0, 10,
             0.12, "packed-int4 LLM + int4 tied head + q8 tower, forced 100 steps",
             analytic_bytes_per_iter=_tree_bytes(tower) + 100 * step_b)


def bench_qwen_asr_q4_batch8():
    """Batch-8 concurrent q4 decode: weight streaming (the decode-step
    bottleneck — ~300 MB of int4 bytes/step) is amortized across 8
    utterances in one while_loop, the throughput configuration
    (the reference is strictly batch-1, one ORT launch per token)."""
    from asr_jax.models import qwen_asr as qa
    from asr_jax.layers import qwen3
    from asr_jax.decode.ar import DecodeConfig
    from asr_jax.quant.quantize import quantize_pytree
    cfg = qa.QwenAsrConfig()
    tower = quantize_pytree(qa.init_tower_params(cfg, jax.random.PRNGKey(0)), bits=8)
    llm = qwen3.fuse_params(
        quantize_pytree(qwen3.init_params(cfg.llm, jax.random.PRNGKey(1)),
                        bits=4, pack=True, quantize_embeddings=True), cfg.llm)
    audio, valid = _audio(8, 8.0, scale=0.1)
    rep = lambda row: jnp.tile(jnp.asarray([row], jnp.int32), (8, 1))
    ids = {"head": rep([1, 2, 3]), "query": rep([4, 5]),
           "suffix": rep([6]), "tail": rep([7, 8])}
    dc = DecodeConfig(max_new_tokens=100, eot_id=-1)
    fn = jax.jit(lambda t, l, a, v: qa.forward(t, l, cfg, a, v, ids, dc))
    _measure("qwen3_asr_0.6b_q4f32_batch8", fn, (tower, llm, audio, valid), 8, 8.0, 3,
             0.12, "8 utterances per decode loop, packed-int4 + int4 tied head + q8 tower, forced 100 steps")


def bench_qwen_asr_continuous():
    """Continuous-batching steady state (parallel/llm_batcher.py): 8 live
    slots advanced by one rowwise step per token (bf16 KV planes). Timed
    as 50 steps chained inside one jit; the row's RTF is card-level
    throughput (divided by
    the 8 concurrent requests) for 100-token / 8 s utterances — multiply
    by 8 for the per-request latency RTF. Joins cost one bucketed prefill
    dispatch and do not stall the running slots."""
    from jax import lax
    from asr_jax.decode.ar import DecodeConfig
    from asr_jax.layers import qwen3
    from asr_jax.models import qwen_asr as qa
    from asr_jax.parallel.llm_batcher import ContinuousLlmBatcher
    from asr_jax.quant.quantize import quantize_pytree

    cfg = qa.QwenAsrConfig()
    llm = qwen3.fuse_params(
        quantize_pytree(qwen3.init_params(cfg.llm, jax.random.PRNGKey(1)),
                        bits=4, pack=True, quantize_embeddings=True), cfg.llm)
    dc = DecodeConfig(max_new_tokens=100, eot_id=-1)
    bat = ContinuousLlmBatcher(llm, cfg.llm, dc, n_slots=8, t_max=512,
                               kv_dtype=jnp.bfloat16)
    # Seed the steady state directly: 8 slots mid-decode at a realistic
    # position (prompt ~230 tokens for an 8 s window). KV contents don't
    # affect the timing — shapes are fixed.
    pos = jnp.full((8,), 230, jnp.int32)
    last = jnp.arange(8, dtype=jnp.int32) + 10
    count = jnp.ones((8,), jnp.int32)
    active = jnp.ones((8,), bool)

    def loop(state, gen, pos, last, count, active, keys, params):
        def body(_, carry):
            return bat._step_impl(*carry, params)[:7]
        return lax.fori_loop(
            0, 50, body, (state, gen, pos, last, count, active, keys))

    fn = jax.jit(loop)
    args = (bat.state, bat.gen_buf, pos, last, count, active, bat.keys, llm)
    # 50 steps = half a 100-step request over 8 slots -> batch 8 x 4 s of
    # audio per timed call (same chip-level-throughput convention as the
    # lockstep batch8 row).
    # analytic per-iter flops (XLA's cost model does not see the fori loop): per slot per token = decoder matmuls + GQA
    # attention over the 512-slot cache + tied head; x 8 slots x 50 steps.
    lc = cfg.llm
    qd, kvd = lc.num_heads * lc.head_dim, lc.num_kv_heads * lc.head_dim
    per_tok = (lc.num_layers * (2 * lc.hidden * (qd + 2 * kvd) + 2 * qd * lc.hidden
                                + 6 * lc.hidden * lc.ffn_dim + 4 * qd * 512)
               + 2 * lc.hidden * lc.vocab_size)
    # analytic per-step traffic: the weights stream ONCE for all 8 slots;
    # each slot reads its bf16 KV planes over all 512 cache slots (k+v,
    # GQA width).
    wbytes = _tree_bytes(llm)
    kv_bytes = 8 * lc.num_layers * 2 * 2 * 512 * kvd
    _measure("qwen3_asr_0.6b_q4_continuous8", fn, args, 8, 4.0, 5,
             0.12, "continuous batching steady state: 8 slots, rowwise "
             "step, packed-int4 + int4 tied head, bf16 KV planes; "
             "per-request latency RTF = 8x this row",
             analytic_flops_per_iter=8 * 50 * per_tok,
             analytic_bytes_per_iter=50 * (wbytes + kv_bytes))


def bench_whisper_continuous8(n_slots: int = 8):
    """Continuous AED batching steady state (parallel/aed_batcher.py):
    N live Whisper-Turbo requests advanced by one rowwise step per token
    (per-slot self + cross attention over per-slot encoder outputs, q8
    tied head; bf16 KV/cross planes). Timed as 50 steps chained inside one
    jit; the row's RTF is card-level throughput (divided by
    the N concurrent requests) for 200-token / 30 s windows — multiply by
    N for the per-request latency RTF. A join costs one solo prefill
    dispatch (wh.prefill_window) and does not stall the running slots.
    The weight stream amortizes with N, so deeper slot counts trade
    per-request latency for aggregate throughput (the 16-slot row)."""
    from jax import lax
    from asr_jax.decode.ar import DecodeConfig
    from asr_jax.models import whisper as wh
    from asr_jax.parallel.aed_batcher import (ContinuousAedBatcher,
                                              spec_for_whisper)
    from asr_jax.quant.quantize import cast_pytree, quantize_pytree

    cfg = wh.WhisperConfig()
    params = cast_pytree(
        quantize_pytree(wh.init_params(cfg, jax.random.PRNGKey(0)), bits=8,
                        quantize_embeddings=True), jnp.bfloat16)
    dc = DecodeConfig(max_new_tokens=200, eot_id=-1)
    n = n_slots
    bat = ContinuousAedBatcher(params, spec_for_whisper(cfg), dc, n_slots=n,
                               kv_dtype=jnp.bfloat16)
    # Steady state: N slots mid-decode just past the 4-token prompt, each
    # with a full 30 s window's cross length. KV contents don't affect the
    # timing — shapes are fixed.
    pos = jnp.full((n,), 40, jnp.int32)
    tcv = jnp.full((n,), 1500, jnp.int32)
    last = jnp.arange(n, dtype=jnp.int32) + 10
    count = jnp.full((n,), 36, jnp.int32)
    active = jnp.ones((n,), bool)

    def loop(state, gen, pos, tcv, last, count, active, keys, dec):
        def body(_, carry):
            return bat._step_impl(*carry, dec)[:8]
        return lax.fori_loop(
            0, 50, body, (state, gen, pos, tcv, last, count, active, keys))

    fn = jax.jit(loop)
    args = (bat.state, bat.gen_buf, pos, tcv, last, count, active, bat.keys,
            bat.dec)
    # 50 steps = a quarter of a 200-step window over N slots -> batch N x
    # 7.5 s of audio per timed call (same chip-level-throughput convention
    # as the lockstep whisper_q8 batch-8 row).
    # analytic per-iter flops (the cost model does not see the fori loop):
    # per slot per token = 6 decoder linears + self attn over 448 + cross
    # attn over 1504 + q8 tied head; x N slots x 50 steps.
    d, f_, v = cfg.d_model, cfg.ffn_dim, cfg.vocab_size
    per_tok = (cfg.decoder_layers * (12 * d * d + 4 * d * f_
                                     + 4 * d * (448 + 1504)) + 2 * d * v)
    # analytic per-step traffic: the decoder weights stream ONCE for all N
    # slots; each slot reads bf16 self-KV (448 rows) + bf16 cross-KV (1500
    # encoder positions), k+v each.
    wbytes = _tree_bytes(params["decoder"])
    kv_bytes = n * cfg.decoder_layers * 2 * 2 * (448 + 1500) * cfg.d_model
    _measure(f"whisper_large_v3_turbo_q8_continuous{n}", fn, args, n, 7.5, 5,
             0.073, f"continuous AED batching steady state: {n} slots, rowwise "
             "step (per-slot cross-KV, q8 tied head), bf16 KV/cross planes; "
             f"per-request latency RTF = {n}x this row; ref README.md:55",
             analytic_flops_per_iter=n * 50 * per_tok,
             analytic_bytes_per_iter=50 * (wbytes + kv_bytes))


def bench_fun_asr_nano_llm_q4():
    """q4f32 LLM path — the reference's measured config (README.md:61).

    Embeddings quantized too (the reference quantizes Decoder_Embed to Q8,
    ``Fun_ASR_Nano/Optimize_ONNX.py:107-112``; without it the tied LM head
    is a 622 MB f32 HBM read per decode step and dominates the row)."""
    from asr_jax.models import fun_asr_nano as fn_
    from asr_jax.layers import qwen3
    from asr_jax.decode.ar import DecodeConfig
    from asr_jax.quant.quantize import quantize_pytree
    cfg = fn_.FunAsrNanoConfig()
    params = quantize_pytree(fn_.init_params(cfg, jax.random.PRNGKey(0)), bits=8)
    llm = quantize_pytree(qwen3.init_params(cfg.llm, jax.random.PRNGKey(1)),
                          bits=4, pack=True, quantize_embeddings=True)
    audio, valid = _audio(1, 8.0)
    ids = {
        "head": jnp.asarray([[1, 2, 3]], jnp.int32),
        "query": jnp.asarray([[4, 5]], jnp.int32),
        "tail": jnp.asarray([[6, 7]], jnp.int32),
    }
    dc = DecodeConfig(max_new_tokens=100, eot_id=-1)
    llm = qwen3.fuse_params(llm, cfg.llm)  # session-identical: fused leaves
    fn = jax.jit(lambda p, l, a, v: fn_.forward_llm(p, l, cfg, a, v, ids, dc))
    _measure("fun_asr_nano_llm_q4f32", fn, (params, llm, audio, valid), 1, 8.0, 10,
             0.11, "packed-int4 LLM + int4 tied head + q8 encoder, "
                   "forced 100 steps; ref README.md:61 q4f32")


def bench_fun_asr_llm_batch8():
    """Batch-8 Fun-ASR-Nano LLM decode (left-padded lockstep; weight
    streaming amortized across 8 utterances, reference is batch-1)."""
    from asr_jax.models import fun_asr_nano as fn_
    from asr_jax.layers import qwen3
    from asr_jax.decode.ar import DecodeConfig
    from asr_jax.quant.quantize import quantize_pytree
    cfg = fn_.FunAsrNanoConfig()
    params = quantize_pytree(fn_.init_params(cfg, jax.random.PRNGKey(0)), bits=8)
    llm = qwen3.fuse_params(
        quantize_pytree(qwen3.init_params(cfg.llm, jax.random.PRNGKey(1)),
                        bits=4, pack=True, quantize_embeddings=True), cfg.llm)
    audio, valid = _audio(8, 8.0)
    rep = lambda row: jnp.tile(jnp.asarray([row], jnp.int32), (8, 1))
    ids = {"head": rep([1, 2, 3]), "query": rep([4, 5]), "tail": rep([6, 7])}
    dc = DecodeConfig(max_new_tokens=100, eot_id=-1)
    fn = jax.jit(lambda p, l, a, v: fn_.forward_llm(p, l, cfg, a, v, ids, dc))
    _measure("fun_asr_nano_llm_q4f32_batch8", fn, (params, llm, audio, valid), 8, 8.0, 3,
             0.11, "8 utterances per lockstep decode, packed-int4 + int4 tied head, forced 100 steps")


def bench_qwen_asr():
    from asr_jax.models import qwen_asr as qa
    from asr_jax.decode.ar import DecodeConfig
    from asr_jax.layers import qwen3
    cfg = qa.QwenAsrConfig()
    tower = qa.init_tower_params(cfg, jax.random.PRNGKey(0))
    llm = qwen3.init_params(cfg.llm, jax.random.PRNGKey(1))
    audio, valid = _audio(1, 8.0, scale=0.1)
    ids = {
        "head": jnp.asarray([[1, 2, 3]], jnp.int32),
        "query": jnp.asarray([[4, 5]], jnp.int32),
        "suffix": jnp.asarray([[6]], jnp.int32),
        "tail": jnp.asarray([[7, 8]], jnp.int32),
    }
    dc = DecodeConfig(max_new_tokens=100, eot_id=-1)
    fn = jax.jit(lambda t, l, a, v: qa.forward(t, l, cfg, a, v, ids, dc))
    _measure("qwen3_asr_0.6b_f32", fn, (tower, llm, audio, valid), 1, 8.0, 3,
             0.12, "batch 1 (ref layout), forced 100 decode steps; ref README.md:62 q4f32")


def _measure_stream(name, step, args, chunk_seconds, ref_cpu_rtf, note="",
                    iters=25, batch=1, ceiling_tflops=None):
    """Streaming RTF: steady-state per-chunk latency / chunk duration.

    One dispatch per chunk, each ended by ``block_until_ready``; the
    median over ``iters`` chunks (the same chunk and state fed every tick)
    is the per-chunk latency."""
    jax.block_until_ready(step(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(step(*args))
        times.append(time.perf_counter() - t0)
    per_chunk = statistics.median(times)
    rec = {
        "family": name,
        "rtf": round(per_chunk / (batch * chunk_seconds), 6),
        "chunk_ms": round(per_chunk * 1e3, 3),
        "chunk_seconds": chunk_seconds,
        "batch": batch,
        "iters": iters,
        "ref_cpu_rtf": ref_cpu_rtf,
        "speedup_vs_ref": (round(ref_cpu_rtf * batch * chunk_seconds / per_chunk, 1)
                           if ref_cpu_rtf else None),
        "note": note,
        "device": _device(),
    }
    # Cost-model the single step. RNN-T / transducer inner while-loops
    # still undercount (decode is a few % of a streaming chunk's flops; the
    # encoder dominates).
    if ceiling_tflops is None:
        ceiling_tflops = _ceiling(name)
    try:
        ca = jax.jit(step).lower(*args).compile().cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        flops = float(ca.get("flops", 0.0)) or None
    except Exception:
        flops = None
    if flops:
        achieved = flops / per_chunk / 1e12
        if achieved >= 0.05:
            rec["achieved_tflops_per_s"] = round(achieved, 2)
            rec["pct_of_peak_tflops"] = round(100 * achieved / ceiling_tflops, 1)
            rec["peak_tflops"] = ceiling_tflops
    RESULTS.append(rec)
    print(json.dumps(rec), flush=True)


def bench_paraformer_streaming():
    from asr_jax.models import paraformer as pf
    from asr_jax.streaming import paraformer_online as po
    cfg = po.ParaformerStreamConfig(base=pf.ParaformerConfig())
    params = pf.init_params(cfg.base, jax.random.PRNGKey(0))
    state = po.init_state(cfg, params)
    chunk, _ = _audio(1, cfg.chunk_samples / 16000.0)
    enc_j = jax.jit(lambda p, s, c: po.encoder_step(p, cfg, s, c))
    dec_j = jax.jit(lambda p, s, e, f, n: po.decoder_step(p, cfg, s, e, f, n))

    def step(p, s, c):
        s, fired, count, enc_out = enc_j(p, s, c)
        # Worst case: decoder runs every chunk (reference skips on count==0).
        s, ids, n = dec_j(p, s, enc_out, fired, count)
        return s, ids, n

    _measure_stream("paraformer_streaming_f32", step, (params, state, chunk[0][None]),
                    cfg.chunk_samples / 16000.0, 0.06,
                    "0.5 s chunks, decoder forced EVERY chunk; ref README.md:58 i3-12300")


def bench_paraformer_multistream(n_streams: int = 8):
    """N concurrent streaming-Paraformer sessions as ONE vmapped step
    (asr_jax.streaming.multistream): per-stream chunk latency should stay
    ~flat vs single-stream, i.e. N x streaming throughput per chip."""
    from asr_jax.models import paraformer as pf
    from asr_jax.streaming import multistream as ms
    from asr_jax.streaming import paraformer_online as po
    cfg = po.ParaformerStreamConfig(base=pf.ParaformerConfig())
    params = pf.init_params(cfg.base, jax.random.PRNGKey(0))
    runner = ms.paraformer_multistream(params, cfg, n_streams)
    rng = np.random.default_rng(0)
    chunks = jnp.asarray(
        (rng.standard_normal((n_streams, cfg.chunk_samples)) * 2000).astype(np.float32))
    # runner._step is the jitted vmapped (params, states, chunks) ->
    # (states', outputs) tick — exactly the state-first contract
    # _measure_stream's in-jit loop carries.
    _measure_stream(f"paraformer_multistream_x{n_streams}_f32", runner._step,
                    (runner.params, runner.states, chunks),
                    cfg.chunk_samples / 16000.0, 0.06,
                    f"{n_streams} concurrent streams, one vmapped dispatch/tick; "
                    "aggregate RTF (per-stream latency = chunk_ms)",
                    batch=n_streams)


def bench_zipformer_streaming():
    from asr_jax.models import zipformer as zf
    cfg = zf.ZipformerConfig()
    params = zf.init_params(cfg, jax.random.PRNGKey(0))
    state = zf.init_state(cfg)
    window = _audio(1, cfg.window_samples / 16000.0)[0][0]

    def step(p, s, w):
        s, enc = zf.encoder_step(p, cfg, s, w)
        return zf.greedy_chunk(p, cfg, s, enc)

    stepj = jax.jit(step)
    _measure_stream("x_asr_zipformer_stream_f32", stepj, (params, state, window),
                    cfg.chunk_size * 0.04, None,
                    "encoder_step + transducer greedy per chunk (no ref RTF row)")


def bench_nemotron_streaming():
    from asr_jax.models import nemotron as nm
    from asr_jax.streaming import nemotron_stream as ns
    cfg = ns.NemotronStreamConfig(base=nm.NemotronConfig())
    params = nm.init_params(cfg.base, jax.random.PRNGKey(0))
    state = ns.init_state(cfg)
    window = _audio(1, cfg.window_samples / 16000.0, scale=0.1)[0]
    prompt = jnp.zeros((1,), jnp.int32)
    relk = ns.precompute_rel_k(params, cfg)

    def step(p, s, w, pr, rk):
        s, enc_proj = ns.encoder_step(p, cfg, s, w, pr, rk)
        return ns.rnnt_stream_step(p, cfg, s, enc_proj)

    stepj = jax.jit(step)
    chunk_seconds = cfg.mel_chunk * cfg.base.mel.hop_length / 16000.0
    _measure_stream("nemotron_streaming_f32", stepj,
                    (params, state, window, prompt, relk),
                    chunk_seconds, 0.1,
                    "cache-aware chunk + RNN-T continuation, hoisted rel-k cache; "
                    "ref README.md:63 (offline row)")


def bench_dolphin_streaming():
    from asr_jax.models import dolphin as dp
    from asr_jax.streaming import dolphin_stream as ds
    cfg = ds.DolphinStreamConfig(base=dp.DolphinConfig())
    params = dp.init_params(cfg.base, jax.random.PRNGKey(0))
    state = ds.init_state(cfg)
    window = _audio(1, cfg.window_samples / 16000.0)[0][0]
    relk = ds.precompute_rel_k(params, cfg)
    stepj = jax.jit(lambda p, s, w, rk: ds.encoder_step(p, cfg, s, w, rk))
    chunk_seconds = cfg.advance_samples / 16000.0
    _measure_stream("dolphin_cn_stream_f32", stepj, (params, state, window, relk),
                    chunk_seconds, 0.14,
                    "E-Branchformer chunk + in-graph CTC ids, hoisted rel-k cache; "
                    "ref README.md:60 (offline row)")


def bench_paraformer_streaming_q8():
    """q8 streaming Paraformer (VERDICT r4 #4: quantization composes with
    streaming — the hardware row). Same chunk step as the f32 row with
    int8 block-128 weights: every encoder/FSMN/predictor/decoder matmul
    routes through the quant dispatch (token-identity vs dequantized-f32
    is CPU-tested in tests/test_quant_streaming.py; this row measures the
    bf16 serving path on chip). Reference quantizes its streaming graphs
    through the same Optimize_ONNX_Common.py pipeline as offline ones."""
    from asr_jax.models import paraformer as pf
    from asr_jax.quant.quantize import quantize_pytree
    from asr_jax.streaming import paraformer_online as po
    cfg = po.ParaformerStreamConfig(base=pf.ParaformerConfig())
    params = quantize_pytree(pf.init_params(cfg.base, jax.random.PRNGKey(0)),
                             bits=8)
    state = po.init_state(cfg, params)
    chunk, _ = _audio(1, cfg.chunk_samples / 16000.0)
    enc_j = jax.jit(lambda p, s, c: po.encoder_step(p, cfg, s, c))
    dec_j = jax.jit(lambda p, s, e, f, n: po.decoder_step(p, cfg, s, e, f, n))

    def step(p, s, c):
        s, fired, count, enc_out = enc_j(p, s, c)
        s, ids, n = dec_j(p, s, enc_out, fired, count)
        return s, ids, n

    _measure_stream("paraformer_streaming_q8", step,
                    (params, state, chunk[0][None]),
                    cfg.chunk_samples / 16000.0, 0.06,
                    "0.5 s chunks, int8 block-128 weights (bf16 serving route), "
                    "decoder forced EVERY chunk; ref README.md:58")


def bench_dolphin_streaming_q8():
    """q8 streaming Dolphin CN-Dialect (VERDICT r4 #4 second hardware row):
    E-Branchformer chunk encoder with int8 block-128 weights; depthwise
    cgMLP/fusion kernels stay raw f32 (consumed elementwise, excluded by
    the quantizer)."""
    from asr_jax.models import dolphin as dp
    from asr_jax.quant.quantize import quantize_pytree
    from asr_jax.streaming import dolphin_stream as ds
    cfg = ds.DolphinStreamConfig(base=dp.DolphinConfig())
    params = quantize_pytree(dp.init_params(cfg.base, jax.random.PRNGKey(0)),
                             bits=8)
    state = ds.init_state(cfg)
    window = _audio(1, cfg.window_samples / 16000.0)[0][0]
    relk = ds.precompute_rel_k(params, cfg)
    stepj = jax.jit(lambda p, s, w, rk: ds.encoder_step(p, cfg, s, w, rk))
    chunk_seconds = cfg.advance_samples / 16000.0
    _measure_stream("dolphin_cn_stream_q8", stepj, (params, state, window, relk),
                    chunk_seconds, 0.14,
                    "E-Branchformer chunk + in-graph CTC ids, int8 block-128 "
                    "weights (bf16 serving route), hoisted rel-k cache; "
                    "ref README.md:60 (offline row)")


def bench_zipformer_multistream(n_streams: int = 8):
    """N concurrent X-ASR Zipformer streaming sessions as ONE vmapped step:
    the single-stream step is dispatch/latency-bound (19 small layers), so
    vmapping N streams amortizes exactly that overhead — the reference
    runs one process per stream (`X-ASR/Inference_X_ASR_ONNX.py:399-433`)."""
    from asr_jax.models import zipformer as zf
    from asr_jax.streaming import multistream as ms
    cfg = zf.ZipformerConfig()
    params = zf.init_params(cfg, jax.random.PRNGKey(0))
    runner = ms.zipformer_multistream(params, cfg, n_streams)
    rng = np.random.default_rng(0)
    windows = jnp.asarray(
        (rng.standard_normal((n_streams, cfg.window_samples)) * 2000)
        .astype(np.float32))
    _measure_stream(f"zipformer_multistream_x{n_streams}_f32", runner._step,
                    (runner.params, runner.states, windows),
                    cfg.chunk_size * 0.04, None,
                    f"{n_streams} concurrent streams, one vmapped dispatch/tick; "
                    "aggregate RTF (per-stream latency = chunk_ms)",
                    batch=n_streams)


def bench_nemotron_multistream(n_streams: int = 8):
    """N concurrent cache-aware Nemotron streams, one vmapped dispatch."""
    from asr_jax.models import nemotron as nm
    from asr_jax.streaming import multistream as ms
    from asr_jax.streaming import nemotron_stream as ns
    cfg = ns.NemotronStreamConfig(base=nm.NemotronConfig())
    params = nm.init_params(cfg.base, jax.random.PRNGKey(0))
    runner = ms.nemotron_multistream(params, cfg, n_streams)
    rng = np.random.default_rng(0)
    windows = jnp.asarray(
        (rng.standard_normal((n_streams, cfg.window_samples)) * 0.05)
        .astype(np.float32))
    chunk_seconds = cfg.mel_chunk * cfg.base.mel.hop_length / 16000.0
    _measure_stream(f"nemotron_multistream_x{n_streams}_f32", runner._step,
                    (runner.params, runner.states, windows),
                    chunk_seconds, 0.1,
                    f"{n_streams} concurrent streams, one vmapped dispatch/tick; "
                    "ref README.md:63 (offline row)",
                    batch=n_streams)


def bench_dolphin_multistream(n_streams: int = 8):
    """N concurrent Dolphin CN-Dialect-Streaming encoders, one vmapped
    dispatch (streaming CTC ids per chunk)."""
    from asr_jax.models import dolphin as dp
    from asr_jax.streaming import dolphin_stream as ds
    from asr_jax.streaming import multistream as ms
    cfg = ds.DolphinStreamConfig(base=dp.DolphinConfig())
    params = dp.init_params(cfg.base, jax.random.PRNGKey(0))
    runner = ms.dolphin_multistream(params, cfg, n_streams)
    rng = np.random.default_rng(0)
    windows = jnp.asarray(
        (rng.standard_normal((n_streams, cfg.window_samples)) * 2000)
        .astype(np.float32))
    chunk_seconds = cfg.advance_samples / 16000.0
    _measure_stream(f"dolphin_multistream_x{n_streams}_f32", runner._step,
                    (runner.params, runner.states, windows),
                    chunk_seconds, 0.14,
                    f"{n_streams} concurrent streams, one vmapped dispatch/tick; "
                    "ref README.md:60 (offline row)",
                    batch=n_streams)


BENCHES = {
    "sensevoice": bench_sensevoice,
    "sensevoice_bf16": bench_sensevoice_bf16,
    "sensevoice_q8": bench_sensevoice_q8,
    "whisper": bench_whisper,
    "whisper_q8": bench_whisper_q8,
    "whisper_q8_bf16": bench_whisper_q8_bf16,
    "whisper_batch1": bench_whisper_batch1,
    "whisper_continuous8": bench_whisper_continuous8,
    "whisper_continuous16": lambda: bench_whisper_continuous8(16),
    "qwen_asr_q4": bench_qwen_asr_q4,
    "qwen_asr_q4_qembed": bench_qwen_asr_q4_qembed,
    "qwen_asr_q4_batch8": bench_qwen_asr_q4_batch8,
    "qwen_asr_continuous": bench_qwen_asr_continuous,
    "whisper_bf16": lambda: bench_whisper(jnp.bfloat16, "bf16"),
    "paraformer": bench_paraformer,
    "parakeet": bench_parakeet,
    "nemotron": bench_nemotron,
    "firered": bench_firered,
    "firered_q8": bench_firered_q8,
    "firered_q8_batch1": bench_firered_q8_batch1,
    "dolphin": bench_dolphin,
    "dolphin_q8": bench_dolphin_q8,
    "dolphin_q8_batch1": bench_dolphin_q8_batch1,
    "fun_asr_nano": bench_fun_asr_nano_ctc,
    "fun_asr_nano_llm_q4": bench_fun_asr_nano_llm_q4,
    "fun_asr_llm_batch8": bench_fun_asr_llm_batch8,
    "qwen_asr": bench_qwen_asr,
    "paraformer_streaming": bench_paraformer_streaming,
    "paraformer_streaming_q8": bench_paraformer_streaming_q8,
    "paraformer_multistream": bench_paraformer_multistream,
    "zipformer_streaming": bench_zipformer_streaming,
    "zipformer_multistream": bench_zipformer_multistream,
    "nemotron_streaming": bench_nemotron_streaming,
    "nemotron_multistream": bench_nemotron_multistream,
    "dolphin_streaming": bench_dolphin_streaming,
    "dolphin_streaming_q8": bench_dolphin_streaming_q8,
    "dolphin_multistream": bench_dolphin_multistream,
}


def main():
    names = sys.argv[1:] or list(BENCHES)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench_matrix needs a GPU; JAX's default device is {dev}")
    _peaks()
    enable_compile_cache()
    print(f"device: {json.dumps(_device())}", flush=True)
    failures = {}
    for n in names:
        try:
            BENCHES[n]()
        except Exception as e:  # keep going; record the failure
            failures[n] = f"{type(e).__name__}: {e}"
            print(f"FAIL {n}: {failures[n]}", flush=True)
    print(f"\n| Family | {dev.device_kind} RTF | Ref best CPU RTF | Speedup |")
    print("|---|---|---|---|")
    for r in RESULTS:
        print(f"| {r['family']} | {r['rtf']} | {r['ref_cpu_rtf']} | {r['speedup_vs_ref']}x |")
    if failures:
        print("failures:", json.dumps(failures))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
