#!/usr/bin/env python
"""Sustained-load harness for the three serving surfaces on one GPU.

The unit suites prove the servers CORRECT over real HTTP on CPU
(``tests/test_http_server.py`` / ``test_stream_server.py`` /
``test_llm_server.py``); this harness proves them under LOAD on the card:
sustained requests/s, p50/p99 end-to-end latency, and slot/queue occupancy
sampled live from ``/healthz``. Each surface runs at real checkpoint
geometry with random weights (latency is weight-value-independent — decode
loops run fixed budgets), in-process servers on loopback HTTP, closed-loop
client threads for a fixed wall-clock duration. The reference has no
serving layer at all — its counterpart is one-process-per-file script
loops (e.g. ``SenseVoice/Inference_SenseVoice_ONNX.py``).

Surfaces:
  lockstep   -- ``serve`` (micro-batched ``SessionServer``):
                SenseVoiceSmall, MIXED WAV/FLAC bodies of mixed
                lengths (1 s / 4 s / 8 s WAV, 2 s FLAC).
  stream     -- ``serve-stream`` (``StreamingServer``): Paraformer-online,
                N concurrent full-duplex chunked-PCM socket streams.
  continuous -- ``serve --continuous`` (``ContinuousSessionServer``):
                Qwen3-ASR 0.6B q4, STAGGERED joins.

Prints one JSON record per run (device included) and a markdown table;
exits non-zero without a GPU.
Run: ``python tools/load_test.py [lockstep stream continuous]``
     ``[--duration S] [--clients N] [--slots K]``
"""

from __future__ import annotations

import argparse
import io
import json
import os
import socket
import sys
import threading
import time
import urllib.request
import wave

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from asr_jax.runtime.examples import flac_bytes  # noqa: E402

RESULTS: list[dict] = []


def _wav_bytes(samples: np.ndarray, rate: int = 16000) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.asarray(samples, np.int16).tobytes())
    return buf.getvalue()


def _percentiles(lat: list[float]) -> dict:
    a = np.sort(np.asarray(lat))
    return {
        "p50_s": round(float(np.percentile(a, 50)), 4),
        "p90_s": round(float(np.percentile(a, 90)), 4),
        "p99_s": round(float(np.percentile(a, 99)), 4),
        "max_s": round(float(a[-1]), 4),
    }


def _healthz(port: int) -> dict:
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
        return json.loads(r.read())


class _Sampler(threading.Thread):
    """Poll /healthz during the run: live occupancy evidence."""

    def __init__(self, port: int, keys: tuple[str, ...], period: float = 0.5):
        super().__init__(daemon=True)
        self.port, self.keys, self.period = port, keys, period
        self.samples: list[dict] = []
        # NB: must not be named _stop — threading.Thread._stop() is internal
        self._halt = threading.Event()

    def run(self):
        while not self._halt.is_set():
            try:
                h = _healthz(self.port)
                self.samples.append({k: h.get(k) for k in self.keys})
            except Exception:
                pass
            self._halt.wait(self.period)

    def stop(self) -> list[dict]:
        self._halt.set()
        self.join(timeout=5)
        return self.samples


def _closed_loop(port: int, bodies: list[tuple[str, bytes, float]],
                 n_clients: int, duration: float,
                 stagger: float = 0.0) -> dict:
    """N closed-loop clients POSTing mixed bodies for ``duration`` s."""
    lat: list[float] = []
    audio_s: list[float] = []
    errors: list[str] = []
    lock = threading.Lock()
    t_end = time.perf_counter() + duration

    def client(i: int):
        if stagger:
            time.sleep((i / max(n_clients, 1)) * stagger)
        k = i
        while time.perf_counter() < t_end:
            _name, body, secs = bodies[k % len(bodies)]
            k += 1
            t0 = time.perf_counter()
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/transcribe", data=body,
                    method="POST")
                with urllib.request.urlopen(req, timeout=120) as resp:
                    json.loads(resp.read())
            except Exception as exc:
                with lock:
                    errors.append(f"{type(exc).__name__}: {exc}")
                continue
            dt = time.perf_counter() - t0
            with lock:
                lat.append(dt)
                audio_s.append(secs)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if not lat:
        raise RuntimeError(f"no request completed; errors: {errors[:3]}")
    return {
        "clients": n_clients,
        "wall_s": round(wall, 2),
        "requests": len(lat),
        "errors": len(errors),
        "req_per_s": round(len(lat) / wall, 2),
        "audio_seconds_per_s": round(sum(audio_s) / wall, 2),
        **_percentiles(lat),
    }


# ── surfaces ──────────────────────────────────────────────────────────────


def load_lockstep(duration: float, clients: int):
    """serve: micro-batched SessionServer, SenseVoiceSmall, mixed bodies."""
    import jax

    from asr_jax.models import sensevoice as sv
    from asr_jax.parallel.http_server import start_background
    from asr_jax.runtime.session import SenseVoiceSession

    cfg = sv.SenseVoiceConfig()
    params = sv.init_params(cfg, jax.random.PRNGKey(0))
    sess = SenseVoiceSession(params, cfg)
    httpd, srv, _ = start_background(sess, port=0, max_batch=8,
                                     max_wait_ms=5.0, warmup=True)
    port = httpd.server_address[1]
    rng = np.random.default_rng(0)

    def noise(secs):
        return (rng.standard_normal(int(secs * 16000)) * 2000).astype(np.int16)

    bodies = [("wav_1s", _wav_bytes(noise(1.0)), 1.0),
              ("wav_4s", _wav_bytes(noise(4.0)), 4.0),
              ("wav_8s", _wav_bytes(noise(8.0)), 8.0)]
    bodies.append(("flac_2s", flac_bytes(noise(2.0), 16000), 2.0))
    try:
        # warm every body format/length bucket once before timing
        for name, body, _s in bodies:
            req = urllib.request.Request(f"http://127.0.0.1:{port}/transcribe",
                                         data=body, method="POST")
            urllib.request.urlopen(req, timeout=300).read()
        sampler = _Sampler(port, ("queue_depth",))
        sampler.start()
        rec = _closed_loop(port, bodies, clients, duration)
        samples = sampler.stop()
        rec.update({
            "surface": "serve (lockstep micro-batch)",
            "model": "sensevoice_small_f32",
            "bodies": [n for n, _b, _s in bodies],
            "queue_depth_max": max((s.get("queue_depth") or 0)
                                   for s in samples) if samples else None,
            "healthz_final": _healthz(port),
        })
    finally:
        httpd.shutdown()
        srv.close()
    RESULTS.append(rec)
    _flush(rec)


def load_stream(duration: float, n_streams: int, ticks_per_sync: int = 1):
    """serve-stream: N concurrent chunked-PCM socket streams, each sending
    ``duration`` seconds of audio at 2x real-time pace."""
    import jax

    from asr_jax.models import paraformer as pf
    from asr_jax.parallel.stream_server import (start_stream_background,
                                                stream_pcm_over_http)
    from asr_jax.streaming import multistream as ms
    from asr_jax.streaming import paraformer_online as po

    scfg = po.ParaformerStreamConfig(base=pf.ParaformerConfig())
    params = pf.init_params(scfg.base, jax.random.PRNGKey(0))
    runner = ms.paraformer_multistream(params, scfg, n_streams)
    httpd, srv, _ = start_stream_background(runner, scfg.chunk_samples, port=0,
                                            ticks_per_sync=ticks_per_sync)
    port = httpd.server_address[1]
    rng = np.random.default_rng(1)
    secs = duration
    pcm = [(rng.standard_normal(int(secs * 16000)) * 2000).astype(np.int16)
           for _ in range(n_streams)]
    try:
        # one warm stream compiles the tick
        stream_pcm_over_http("127.0.0.1", port, pcm[0][: 4 * scfg.chunk_samples])
        lat: list[float] = []
        ticks: list[int] = []
        errors: list[str] = []
        lock = threading.Lock()

        def client(i):
            t0 = time.perf_counter()
            try:
                events = stream_pcm_over_http("127.0.0.1", port, pcm[i],
                                              timeout=600.0)
            except Exception as exc:
                with lock:
                    errors.append(f"{type(exc).__name__}: {exc}")
                return
            dt = time.perf_counter() - t0
            done = [e for e in events if e.get("done")]
            with lock:
                lat.append(dt)
                ticks.append(done[0]["ticks"] if done else -1)

        sampler = _Sampler(port, ("slots_active",))
        sampler.start()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_streams)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        samples = sampler.stop()
        if not lat:
            raise RuntimeError(f"no stream completed; errors: {errors[:3]}")
        rec = {
            "surface": "serve-stream (chunked-HTTP full duplex)",
            "model": "paraformer_streaming_f32",
            "streams": n_streams,
            "ticks_per_sync": ticks_per_sync,
            "stream_audio_s": secs,
            "wall_s": round(wall, 2),
            "errors": len(errors),
            "aggregate_audio_seconds_per_s": round(
                len(lat) * secs / wall, 2),
            "stream_wall_over_audio": round(max(lat) / secs, 4),
            "ticks": ticks[:4],
            "healthz_final": _healthz(port),
        }
    finally:
        httpd.shutdown()
        srv.close()
    RESULTS.append(rec)
    _flush(rec)


def load_continuous(duration: float, clients: int, n_slots: int,
                    steps_per_tick: int = 8):
    """serve --continuous: Qwen3-ASR 0.6B q4, staggered joins — clients
    ramp in over the first third of the run.

    ``steps_per_tick=8``: the driver fuses 8 decode steps per host sync
    (lax.scan in the batcher), so the host<->device round trip amortizes
    over 8 tokens. Token streams are identical; joins land on tick
    boundaries."""
    import jax
    import jax.numpy as jnp

    from asr_jax.layers import qwen3
    from asr_jax.models import qwen_asr as qa
    from asr_jax.parallel.llm_server import start_background_continuous
    from asr_jax.quant.quantize import quantize_pytree
    from asr_jax.runtime.qwen_session import QwenAsrSession, QwenPromptTemplate

    class _Tok:
        def decode(self, ids):
            return " ".join(map(str, ids))

    cfg = qa.QwenAsrConfig()
    tower = qa.init_tower_params(cfg, jax.random.PRNGKey(0))
    llm = quantize_pytree(qwen3.init_params(cfg.llm, jax.random.PRNGKey(1)),
                          bits=4, pack=True, quantize_embeddings=True)
    sess = QwenAsrSession(tower, llm, cfg, tokenizer=_Tok(),
                          template=QwenPromptTemplate(head_ids=(1, 2),
                                                      tail_ids=(4,)),
                          max_new_tokens=100, max_seconds=8.0)
    httpd, srv, _ = start_background_continuous(sess, port=0, n_slots=n_slots,
                                                warmup=True, kv_dtype="bf16",
                                                steps_per_tick=steps_per_tick)
    port = httpd.server_address[1]
    rng = np.random.default_rng(2)
    secs = 8.0
    bodies = [("wav_8s",
               _wav_bytes((rng.standard_normal(int(secs * 16000)) * 800)
                          .astype(np.int16)), secs)]
    try:
        sampler = _Sampler(port, ("slots_active", "queue_depth"))
        sampler.start()
        rec = _closed_loop(port, bodies, clients, duration,
                           stagger=duration / 3.0)
        samples = sampler.stop()
        occ = [s.get("slots_active") or 0 for s in samples]
        rec.update({
            "surface": "serve --continuous (staggered joins)",
            "model": "qwen3_asr_0.6b_q4_bf16kv",
            "slots": n_slots,
            "steps_per_tick": steps_per_tick,
            "step_kernel": srv.stats().get("step_kernel"),
            "slots_active_mean": round(float(np.mean(occ)), 2) if occ else None,
            "slots_active_max": max(occ) if occ else None,
            "queue_depth_max": max((s.get("queue_depth") or 0)
                                   for s in samples) if samples else None,
            "healthz_final": _healthz(port),
        })
    finally:
        httpd.shutdown()
        srv.close()
    RESULTS.append(rec)
    _flush(rec)


def _flush(rec: dict) -> None:
    dev = jax.devices()[0]
    rec["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                     "count": len(jax.devices())}
    print(json.dumps(rec), flush=True)


SURFACES = {
    "lockstep": load_lockstep,
    "stream": load_stream,
    "continuous": load_continuous,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("surfaces", nargs="*", default=[],
                    help=f"which surfaces to load-test (default: all of "
                         f"{', '.join(SURFACES)})")
    ap.add_argument("--duration", type=float, default=30.0,
                    help="seconds of sustained load per surface")
    ap.add_argument("--clients", type=int, default=16,
                    help="closed-loop client threads (lockstep/continuous)")
    ap.add_argument("--streams", type=int, default=8,
                    help="concurrent PCM streams (stream surface)")
    ap.add_argument("--slots", type=int, default=8,
                    help="decode slots (continuous surface)")
    ap.add_argument("--ticks-per-sync", type=int, default=1,
                    help="stream surface: chunk ticks fused per device "
                         "sync (StreamingServer ticks_per_sync)")
    ap.add_argument("--sweep", action="store_true",
                    help="scaling curves instead of single points: stream "
                         "at 8/16/32 streams, lockstep + continuous at "
                         "16/32/64 clients — shows where aggregate "
                         "throughput knees")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"load_test needs a GPU; JAX's default device is {dev}")
    from asr_jax.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    names = args.surfaces or list(SURFACES)
    unknown = [n for n in names if n not in SURFACES]
    if unknown:
        ap.error(f"unknown surface(s) {unknown}; pick from {list(SURFACES)}")
    failures = {}
    for n in names:
        try:
            if n == "lockstep":
                for c in ((16, 32, 64) if args.sweep else (args.clients,)):
                    load_lockstep(args.duration, c)
            elif n == "stream":
                for s in ((8, 16, 32) if args.sweep else (args.streams,)):
                    load_stream(args.duration, s,
                                ticks_per_sync=args.ticks_per_sync)
            else:
                for c in ((16, 32, 64) if args.sweep else (args.clients,)):
                    load_continuous(args.duration, c, args.slots)
        except Exception as e:
            failures[n] = f"{type(e).__name__}: {e}"
            print(f"FAIL {n}: {failures[n]}", flush=True)
    print("\n| Surface | req/s | p50 | p99 | notes |")
    print("|---|---|---|---|---|")
    for r in RESULTS:
        print(f"| {r['surface']} | {r.get('req_per_s', '—')} "
              f"| {r.get('p50_s', '—')} | {r.get('p99_s', '—')} "
              f"| {r.get('audio_seconds_per_s', r.get('aggregate_audio_seconds_per_s', ''))}"
              " audio-s/s |")
    if failures:
        print("failures:", json.dumps(failures))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
