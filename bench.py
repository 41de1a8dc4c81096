#!/usr/bin/env python
"""Benchmark: SenseVoiceSmall forward on one GPU, batch 8, 8 s audio.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, "device": {...}}

Metric: real-time factor (elapsed seconds per audio second) at batch 8 x
8 s windows, f32 at HIGHEST matmul precision. ``vs_baseline`` = ours /
0.019, the reference's best published SenseVoiceSmall f32 RTF (measured by
the reference on an i3-12300 CPU, its ``README.md:44-64``); lower is better.

Exits non-zero without a GPU: a measurement never falls back to the CPU.
Cells, bounds and per-layer metrics are still to come (ROADMAP S1, S2).
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_RTF = 0.019  # reference's SenseVoiceSmall f32 CPU RTF, its README.md:52
BATCH = 8
WINDOW_SECONDS = 8.0
ITERS = 20
METRIC = "rtf_sensevoice_small_f32_batch8"


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from asr_jax.models import sensevoice as sv
    from asr_jax.runtime.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX's default device is {dev}")
    enable_compile_cache()
    jax.config.update("jax_default_matmul_precision", "highest")

    cfg = sv.SenseVoiceConfig()  # full SenseVoiceSmall geometry (70 SANM blocks)
    params = sv.init_params(cfg, jax.random.PRNGKey(0))
    samples = int(WINDOW_SECONDS * cfg.sample_rate)
    rng = np.random.default_rng(0)
    audio = jnp.asarray((rng.standard_normal((BATCH, samples)) * 2000).astype(np.float32))
    valid = jnp.full((BATCH,), samples, jnp.int32)
    lang = jnp.zeros((BATCH,), jnp.int32)

    t0 = time.perf_counter()
    jax.block_until_ready(sv.forward(params, cfg, audio, valid, lang))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = sv.forward(params, cfg, audio, valid, lang)
    jax.block_until_ready(out)
    elapsed = time.perf_counter() - t0

    rtf = elapsed / (ITERS * BATCH * WINDOW_SECONDS)
    print(json.dumps({
        "metric": METRIC,
        "value": rtf,
        "unit": "s_elapsed_per_s_audio",
        "vs_baseline": rtf / BASELINE_RTF,
        "first_call_s": compile_s,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
