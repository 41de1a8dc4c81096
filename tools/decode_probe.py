#!/usr/bin/env python
"""Measure the q8 decode path on one GPU: XLA's route against the
``quant_matvec`` kernel (``asr_jax/ops/quant_matmul.py``).

1. Each Whisper-large-v3-turbo linear at decode shape (M=1): device time
   per call of both routes, from a ``lax.scan`` over distinct weights so
   every call streams its weight from device memory (more than the 50 MB
   L2 in total) and no host dispatch is timed; weight bytes/s against the
   card's peak; the kernel's deviation from the f32 dequant reference; and
   what XLA's optimized HLO does with the weight. The prefill shape
   (M=1500) is timed on the XLA route.
2. The q8 Whisper-turbo decode step end to end, batch 1
   (``transcribe_window``, difference of two forced step counts) and in
   ``ContinuousAedBatcher`` at 4 slots, in turns per route (xla, kernel,
   kernel, xla), plus device kernel launches per step from a short trace.

Run: ``python tools/decode_probe.py [--out DIR]`` (HLO text and traces go
under DIR, default ``chiprun_out/decode_probe``).
"""

from __future__ import annotations

import argparse
import os
import re
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from asr_jax.ops import quant_matmul as qm  # noqa: E402
from asr_jax.runtime.compile_cache import enable_compile_cache  # noqa: E402

# Dense peaks of the SXM part without sparsity (NVIDIA H100 data sheet),
# at its full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_tflops": 989.0, "hbm_gbps": 3350.0},
}

# Whisper-large-v3-turbo linears (K, N): q/k/v/o and cross q/o, fc1, fc2,
# and the 51866-token tied head padded to a 512 multiple
DECODE_SHAPES = [(1280, 1280), (1280, 3840), (1280, 5120), (5120, 1280), (1280, 52224)]
STREAM_BYTES = 256 << 20  # weights streamed per timed scan


def peaks() -> dict:
    kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise SystemExit(f"no peak figures for device kind {kind!r}")
    return PEAKS[kind]


def set_route(route: str) -> None:
    """'kernel': small-M int8 leaves take quant_matvec; 'xla': never."""
    qm.MATVEC_MAX_M = 8 if route == "kernel" else 0
    jax.clear_caches()


def _wall(fn, *args, iters: int) -> float:
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _hlo_summary(hlo: str) -> str:
    entry = hlo[hlo.index("ENTRY"):]
    entry = entry[:entry.index("\n}")]
    ops = re.findall(r"= \(?(\w+\[[\d,]*\])\S* (fusion|custom-call)\(.*?(?:kind=(\w+)|"
                     r"custom_call_target=\"([^\"]+)\")", entry)
    return "; ".join(f"{kind or tgt} -> {shape}" for shape, _, kind, tgt in ops)


def quant_dense_probe(out: Path, pk: dict) -> None:
    from asr_jax.quant.quantize import dequantize_weight, quantize_linear

    print("quant_dense at decode shapes, q8 block 128, bf16 mode:", flush=True)
    for k, n in DECODE_SHAPES:
        reps = max(2, STREAM_BYTES // (k * n))
        key = jax.random.PRNGKey(k + n)
        ql = quantize_linear(jax.random.normal(key, (k, n)) * 0.02, bits=8, block=128)
        wbytes = k * n + 2 * 4 * (k // 128) * n
        x = jax.random.normal(key, (1, k), jnp.float32)
        ref = jnp.dot(x, dequantize_weight(ql), precision=jax.lax.Precision.HIGHEST)
        got = qm.quant_matvec(x, ql["q"], ql["scale"], ql["zero"])
        dev = float(jnp.abs(got - ref).max() / jnp.abs(ref).max())
        stack = lambda a: jnp.broadcast_to(a, (reps,) + a.shape) + 0  # distinct buffers
        qs, ss, zs = stack(ql["q"]), stack(ql["scale"]), stack(ql["zero"])
        xs = jax.random.normal(key, (reps, 1, k), jnp.float32)
        line = f"  K={k:5d} N={n:6d} (x{reps}):"
        for route in ("xla", "kernel"):
            set_route(route)

            @jax.jit
            def many(xs, qs, ss, zs):
                def body(c, a):
                    xi, qi, si, zi = a
                    leaf = {"q": qi, "scale": si, "zero": zi, "bits": 8, "block": 128}
                    return c, qm.quant_dense(xi, leaf)
                return jax.lax.scan(body, 0, (xs, qs, ss, zs))[1]

            t = _wall(many, xs, qs, ss, zs, iters=10) / reps
            line += (f" {route} {t * 1e6:7.1f} us ({wbytes / t / 1e9:6.0f} GB/s, "
                     f"{wbytes / t / 1e9 / pk['hbm_gbps']:.1%});")
            if route == "xla":
                hlo = jax.jit(qm._xla_quant_dense).lower(x, ql).compile().as_text()
                (out / f"quant_dense_m1_k{k}_n{n}.hlo.txt").write_text(hlo)
                summary = _hlo_summary(hlo)
        print(f"{line} kernel vs f32 ref {dev:.2e}; XLA HLO: {summary}", flush=True)
        xp = jax.random.normal(key, (1500, k), jnp.float32)
        t = _wall(jax.jit(qm._xla_quant_dense), xp, ql, iters=20)
        hlo = jax.jit(qm._xla_quant_dense).lower(xp, ql).compile().as_text()
        print(f"  K={k:5d} N={n:6d} M=1500 xla {t * 1e6:8.1f} us "
              f"({2 * 1500 * k * n / t / 1e12:.0f} TFLOP/s, "
              f"{2 * 1500 * k * n / t / 1e12 / pk['bf16_tflops']:.1%} of bf16 peak); "
              f"XLA HLO: {_hlo_summary(hlo)}", flush=True)


def _tree_bytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize for x in jax.tree.leaves(tree))


def decode_probe(out: Path, pk: dict) -> None:
    from asr_jax.decode.ar import DecodeConfig
    from asr_jax.models import whisper as wh
    from asr_jax.parallel.aed_batcher import ContinuousAedBatcher, spec_for_whisper
    from asr_jax.quant.quantize import quantize_pytree

    cfg = wh.WhisperConfig()
    params = quantize_pytree(wh.init_params(cfg, jax.random.PRNGKey(0)), bits=8)
    mel = wh.mel_for_audio(cfg, jax.random.normal(jax.random.PRNGKey(1), (1, 480000)) * 0.1)
    prompt = jnp.asarray([[cfg.sot_id, -1, cfg.transcribe_id, cfg.no_timestamps_id]],
                         jnp.int32)
    dec_bytes = _tree_bytes(params["decoder"]) - _tree_bytes(params["decoder"]["pos"])
    nl, d = cfg.decoder_layers, cfg.d_model
    cache = lambda slots: 4 * nl * slots * 2 * d * (cfg.max_target_positions
                                                    + cfg.max_source_positions)
    print(f"decoder weights read per step {dec_bytes / 1e6:.1f} MB (q8 linears + f32 "
          f"tied head), f32 self+cross caches {cache(1) / 1e6:.1f} MB per slot", flush=True)
    for route in ("xla", "kernel", "kernel", "xla"):
        set_route(route)
        t = {}
        ids = {}
        for steps in (32, 96):
            dc = DecodeConfig(max_new_tokens=steps, eot_id=-1)
            run = lambda m: wh.transcribe_window(params, cfg, m, prompt, dc)["tokens"]
            t[steps] = _wall(run, mel, iters=5)
            ids[steps] = np.asarray(run(mel))[0, 4:36].tolist()
        step1 = (t[96] - t[32]) / 64
        b1 = dec_bytes + cache(1)
        print(f"[{route}] batch-1 step {step1 * 1e3:.4f} ms (window {t[32]:.4f} s at 32 "
              f"steps, {t[96]:.4f} s at 96): {b1 / step1 / 1e9:.0f} GB/s "
              f"({b1 / step1 / 1e9 / pk['hbm_gbps']:.1%}); first ids {ids[32][:8]}",
              flush=True)

        slots = 4
        dc = DecodeConfig(max_new_tokens=400, eot_id=-1)
        bat = ContinuousAedBatcher(params, spec_for_whisper(cfg), dc, n_slots=slots)
        pre = wh.prefill_window(params, cfg, mel, prompt, dc)
        tc = pre["state"]["layers"][0]["cross_k"].shape[1]
        for _ in range(slots):
            bat.try_submit(pre["state"], prompt.shape[1], pre["logits0"], tc)
        for _ in range(3):
            bat.step()
        times = []
        for _ in range(40):
            t0 = time.perf_counter()
            bat.step()  # ends in a host read of the step's tokens
            times.append(time.perf_counter() - t0)
        stepn = statistics.median(times)
        b4 = dec_bytes + cache(slots)
        print(f"[{route}] {slots}-slot continuous step {stepn * 1e3:.4f} ms (incl. the "
              f"per-step host read): {b4 / stepn / 1e9:.0f} GB/s "
              f"({b4 / stepn / 1e9 / pk['hbm_gbps']:.1%})", flush=True)
        trace_dir = out / f"trace_{route}"
        if trace_dir.exists():
            continue
        n_traced = 10
        with jax.profiler.trace(str(trace_dir)):
            for _ in range(n_traced):
                bat.step()
        pb = sorted(trace_dir.rglob("*.xplane.pb"))[-1]
        prof = jax.profiler.ProfileData.from_file(str(pb))
        for plane in prof.planes:
            if "GPU:0" not in plane.name:
                continue
            for line in plane.lines:
                evs = list(line.events)
                busy = sum(e.duration_ns for e in evs) / 1e6 / n_traced
                print(f"[{route}] trace {line.name!r}: {len(evs) / n_traced:.1f} events "
                      f"and {busy:.4f} ms of device time per 4-slot step", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/decode_probe")
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"needs a GPU, JAX's default device is {jax.devices()[0]}")
    enable_compile_cache()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    pk = peaks()
    print(f"device: {jax.devices()[0].device_kind}, peaks {pk}", flush=True)
    quant_dense_probe(out, pk)
    decode_probe(out, pk)
    return 0


if __name__ == "__main__":
    sys.exit(main())
