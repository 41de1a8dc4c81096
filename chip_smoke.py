#!/usr/bin/env python3
"""Bring-up check of the serving path on one NVIDIA GPU.

    python chip_smoke.py [--seed N]        # one card
    python chip_smoke.py --four-cards      # the multi-card paths only

Phases, in order, in one process (the only other process is one
``nvidia-smi`` query); any failure exits non-zero:

1. device: the default JAX device must be a GPU (no CPU fallback);
2. serve: full-width SenseVoiceSmall (random weights from ``--seed``) is
   written as an artifact, built with the CLI's ``_build_session`` and
   served by ``SessionServer`` on 127.0.0.1; four concurrent WAV requests
   (16 kHz mono 3 s and 8 s, 48 kHz stereo 5 s, 16 kHz mono 20 s) must get
   HTTP 200 and the ids of a direct ``session.transcribe``; then
   ``python -m asr_jax transcribe`` runs once in-process;
3. numerics: the encoder + CTC logits of one 8 s window on the GPU at
   HIGHEST precision against the same jitted function on the host CPU
   (the other phases also run at HIGHEST: they compare ids across batch
   shapes, which TF32 rounding alone can flip);
4. decode: Whisper-large-v3-turbo geometry, q8, batch-1
   ``transcribe_window`` with forced steps, and the same requests through
   ``ContinuousAedBatcher`` (4 slots, staggered joins) with equal ids;
   one ``quant_dense`` at a decode shape against the f32 dequant reference.

``--four-cards`` runs only what exists across cards: SenseVoice
``--data-parallel 4`` and dp 2 x tp 2 against the one-card ids, and
``serve --continuous --data-parallel 4`` with Whisper q8, one request per
replica, against the one-card solo run.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

# The CPU backend serves as the reference in phase 3; keep it reachable
# when the platform list is pinned (the first entry stays the default).
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from asr_jax.runtime.compile_cache import enable_compile_cache  # noqa: E402
from asr_jax.runtime.examples import synth_audio, wav_bytes  # noqa: E402

# (sample rate, channels, seconds) of the phase-2 requests
SERVE_REQUESTS = ((16000, 1, 3.0), (16000, 1, 8.0), (48000, 2, 5.0), (16000, 1, 20.0))
# phase-3 gate: max |gpu - cpu| / max |cpu| over the CTC logits at HIGHEST
LOGITS_RTOL = 1e-4
# phase-4 gate on one quant_dense against the f32 dequant reference:
# f32 mode (HIGHEST) is exact up to summation order; bf16 mode rounds each
# operand to 8 mantissa bits (~2^-8 relative, well under the q8 error)
QDENSE_F32_RTOL = 1e-5
QDENSE_BF16_RTOL = 2e-2
# one Whisper window; tiny rehearsal configurations shorten it
WHISPER_WINDOW_S = 30.0


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(line.strip() for line in out.stdout.splitlines() if line.strip())


def device_phase(want_count: int) -> dict:
    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    if info["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {dev} ({info['platform']})")
    if info["count"] < want_count:
        raise SystemExit(f"needs {want_count} GPUs, JAX sees {info['count']}")
    log(f"device: platform={info['platform']} kind={info['kind']} "
        f"count={info['count']} nvidia-smi: {card_line()}")
    return info


# ── artifacts ──────────────────────────────────────────────────────────────


def write_sensevoice_artifact(folder: Path, cfg, seed: int) -> Path:
    """Random SenseVoice weights from ``seed`` + a generated ``vocab_txt``
    tokenizer, saved the way ``asr_jax build`` saves artifacts."""
    from asr_jax.models import sensevoice as sv
    from asr_jax.runtime.artifact import save_model
    from asr_jax.runtime.metadata import ModelMetadata

    params = sv.init_params(cfg, jax.random.PRNGKey(seed))
    meta = ModelMetadata(
        family="sensevoice", sample_rate=cfg.sample_rate,
        tokenizer={"kind": "vocab_txt", "file": "tokens.txt"},
        extra={"config": dataclasses.asdict(cfg), "decode_mode": "en"})
    save_model(folder, params, meta)
    tokens = ["<blank>"] + [f"w{i}" for i in range(1, cfg.vocab_size)]
    (folder / "tokens.txt").write_text("\n".join(tokens) + "\n", encoding="utf-8")
    return folder


def write_request_wavs(folder: Path, requests, seed: int) -> list[Path]:
    paths = []
    for i, (rate, channels, seconds) in enumerate(requests):
        pcm = synth_audio(int(rate * seconds), rate, channels, seed=seed * 100 + i)
        path = folder / f"req{i}_{rate // 1000}k_{channels}ch_{seconds:g}s.wav"
        path.write_bytes(wav_bytes(pcm, rate))
        paths.append(path)
    return paths


# ── phase 2: serve ─────────────────────────────────────────────────────────


def _post(url: str, body: bytes, out: dict, i: int) -> None:
    t0 = time.perf_counter()
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "audio/wav"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            out[i] = {"status": resp.status, "body": json.loads(resp.read()),
                      "latency_s": time.perf_counter() - t0}
    except urllib.error.HTTPError as exc:
        out[i] = {"status": exc.code, "body": exc.read().decode(errors="replace"),
                  "latency_s": time.perf_counter() - t0}


def serve_and_compare(model_dir: Path, wavs: list[Path]) -> list[dict]:
    """Build the session as ``cmd_serve`` does, serve it on 127.0.0.1,
    POST every WAV concurrently, and check status and ids against a direct
    ``session.transcribe`` of the same file. Returns one record per
    request."""
    from asr_jax.cli import _build_session
    from asr_jax.parallel.http_server import SessionServer, make_http_server

    t0 = time.perf_counter()
    sess = _build_session(model_dir)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    srv = SessionServer(sess)  # warmup compiles the batch forward
    t_warm = time.perf_counter() - t0
    httpd = make_http_server(srv, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/transcribe"
        out: dict = {}
        posts = [threading.Thread(target=_post, args=(url, p.read_bytes(), out, i))
                 for i, p in enumerate(wavs)]
        for t in posts:
            t.start()
        for t in posts:
            t.join()
        stats = srv.stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    log(f"serve: session built in {t_build:.2f} s, warm-up (compile) {t_warm:.2f} s, "
        f"{stats['batches_dispatched']} batches for {stats['requests_served']} windows")
    records = []
    for i, path in enumerate(wavs):
        got = out.get(i)
        if got is None or got["status"] != 200:
            raise AssertionError(f"{path.name}: HTTP {got and got['status']}: "
                                 f"{got and got['body']}")
        direct = sess.transcribe(path)
        body = got["body"]
        if body["token_ids"] != direct.token_ids:
            raise AssertionError(f"{path.name}: served ids differ from direct transcribe")
        if body["text"] != direct.text:
            raise AssertionError(f"{path.name}: served text differs from direct transcribe")
        records.append({"file": path.name, "latency_s": got["latency_s"],
                        "windows": body.get("windows", 1),
                        "n_ids": len(body["token_ids"])})
        log(f"serve: {path.name} HTTP 200 in {got['latency_s']:.3f} s, "
            f"{records[-1]['windows']} window(s), {records[-1]['n_ids']} ids == direct")
    return records


def serve_phase(cfg, seed: int, workdir: Path) -> None:
    model_dir = write_sensevoice_artifact(workdir / "sensevoice", cfg, seed)
    wavs = write_request_wavs(workdir, SERVE_REQUESTS, seed)
    serve_and_compare(model_dir, wavs)
    from asr_jax.cli import main as cli_main

    rc = cli_main(["transcribe", "--model-dir", str(model_dir), str(wavs[1])])
    if rc != 0:
        raise AssertionError(f"cli transcribe exited {rc}")
    log("serve: cli transcribe ok")


# ── phase 3: numerics against the CPU ──────────────────────────────────────


def _rel_dev(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def numerics_phase(cfg, seed: int) -> None:
    from asr_jax.models import sensevoice as sv

    params = sv.init_params(cfg, jax.random.PRNGKey(seed))
    n = 8 * cfg.sample_rate
    audio = synth_audio(n, cfg.sample_rate, 1, seed=seed).astype(np.float32).T
    args = (jnp.asarray(audio), jnp.asarray([n], jnp.int32), jnp.asarray([0], jnp.int32))
    fn = jax.jit(lambda p, a, v, l: sv.encode_logits(p, cfg, a, v, l))
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        t0 = time.perf_counter()
        gpu_logits, valid = jax.block_until_ready(fn(params, *args))
        t_gpu = time.perf_counter() - t0
        cpu_logits, _ = fn(jax.device_put(params, cpu), *jax.device_put(args, cpu))
    with jax.default_matmul_precision("default"):
        gpu_default, _ = fn(params, *args)
    t = int(valid[0])
    ref = np.asarray(cpu_logits)[0, :t]
    dev_highest = _rel_dev(np.asarray(gpu_logits)[0, :t], ref)
    dev_default = _rel_dev(np.asarray(gpu_default)[0, :t], ref)
    same = np.array_equal(np.asarray(gpu_logits)[0, :t].argmax(-1), ref.argmax(-1))
    log(f"numerics: default-precision logits deviation {dev_default:.3e} "
        f"(not gated)")
    log(f"numerics: HIGHEST logits deviation {dev_highest:.3e} "
        f"(gate {LOGITS_RTOL:g}), argmax equal over {t} frames: {same}, "
        f"first GPU call incl. compile {t_gpu:.2f} s")
    if not (dev_highest <= LOGITS_RTOL and same):
        raise AssertionError("GPU logits disagree with the CPU reference")


# ── phase 4: q8 AED decode ─────────────────────────────────────────────────


def whisper_q8(cfg, seed: int):
    from asr_jax.models import whisper as wh
    from asr_jax.quant.quantize import quantize_pytree

    return quantize_pytree(wh.init_params(cfg, jax.random.PRNGKey(seed)), bits=8)


def whisper_pcm(cfg, seed: int, i: int) -> np.ndarray:
    """One window of int16 mono audio for request ``i``."""
    n = int(WHISPER_WINDOW_S * cfg.sample_rate)
    return synth_audio(n, cfg.sample_rate, 1, seed=seed * 100 + i)[:, 0]


def decode_phase(cfg, seed: int, steps: int = 32, n_requests: int = 4) -> None:
    from asr_jax.decode.ar import DecodeConfig
    from asr_jax.models import whisper as wh
    from asr_jax.parallel.aed_batcher import ContinuousAedBatcher, spec_for_whisper

    params = whisper_q8(cfg, seed)
    # eot_id -1 never matches: every request decodes exactly `steps` tokens
    dc = DecodeConfig(max_new_tokens=steps, eot_id=-1)
    prompt = jnp.asarray([[cfg.sot_id, -1, cfg.transcribe_id, cfg.no_timestamps_id]],
                         jnp.int32)
    p_len = prompt.shape[1]
    mels = [wh.mel_for_audio(cfg, jnp.asarray(whisper_pcm(cfg, seed, i) / 32768.0)[None])
            for i in range(n_requests)]

    solo, t_solo = [], []
    for mel in mels:
        t0 = time.perf_counter()
        out = wh.transcribe_window(params, cfg, mel, prompt, dc)
        c = int(jax.block_until_ready(out["counts"])[0])
        t_solo.append(time.perf_counter() - t0)
        solo.append([int(t) for t in np.asarray(out["tokens"])[0, p_len:p_len + c]])
    log(f"decode: batch-1 transcribe_window, {steps} forced steps: "
        f"{t_solo[0]:.2f} s first (compile), {min(t_solo[1:]):.3f} s warm")

    bat = ContinuousAedBatcher(params, spec_for_whisper(cfg), dc, n_slots=n_requests)
    got: dict[int, list[int]] = {}
    slots: dict[int, int] = {}

    def submit(i):
        pre = wh.prefill_window(params, cfg, mels[i], prompt, dc)
        tc = pre["state"]["layers"][0]["cross_k"].shape[1]
        slots[bat.try_submit(pre["state"], p_len, pre["logits0"], tc)] = i

    def tick():
        for slot, _tok, fin in bat.step_tick():
            if fin and slot in slots:
                got[slots.pop(slot)] = bat.take_result(slot)

    t0 = time.perf_counter()
    for i in range(n_requests):  # staggered joins: one more request every 3 steps
        submit(i)
        for _ in range(3):
            tick()
    while slots:
        tick()
    t_bat = time.perf_counter() - t0
    for i in range(n_requests):
        if got.get(i) != solo[i]:
            raise AssertionError(f"request {i}: continuous ids differ from the solo run")
    log(f"decode: ContinuousAedBatcher {n_requests} slots, staggered joins: ids == solo "
        f"for all {n_requests} ({t_bat:.2f} s incl. compile)")
    step_args = (bat.state, bat.gen_buf, bat.pos, bat.tc_valid, bat.last,
                 bat.count, bat.active, bat.keys, bat.dec)
    mem = bat._step.lower(*step_args).compile().memory_analysis()
    log(f"decode: step memory_analysis: {mem}")
    quant_dense_check(seed)


def quant_dense_check(seed: int, m: int = 1, k: int = 1280, n: int = 5120) -> None:
    from asr_jax.ops.quant_matmul import quant_dense, set_quant_config
    from asr_jax.quant.quantize import dequantize_weight, quantize_linear

    key_w, key_x = jax.random.split(jax.random.PRNGKey(seed))
    w = jax.random.normal(key_w, (k, n), jnp.float32) * 0.02
    x = jax.random.normal(key_x, (m, k), jnp.float32)
    qleaf = quantize_linear(w, bits=8, block=128)
    ref = jnp.dot(x, dequantize_weight(qleaf), precision=jax.lax.Precision.HIGHEST)
    devs = {}
    try:
        for mode in ("f32", "bf16"):
            set_quant_config(mm=mode)
            # a fresh function per mode: the mode is read at trace time
            devs[mode] = _rel_dev(jax.jit(lambda a, q: quant_dense(a, q))(x, qleaf), ref)
    finally:
        set_quant_config(mm=None)
    log(f"decode: quant_dense ({m}x{k} @ q8 {k}x{n}) vs f32 dequant reference: "
        f"f32 mode {devs['f32']:.2e} (gate {QDENSE_F32_RTOL:g}), "
        f"bf16 mode {devs['bf16']:.2e} (gate {QDENSE_BF16_RTOL:g})")
    if devs["f32"] > QDENSE_F32_RTOL or devs["bf16"] > QDENSE_BF16_RTOL:
        raise AssertionError("quant_dense outside its tolerance")


# ── --four-cards ───────────────────────────────────────────────────────────


def four_card_phase(sv_cfg, wh_cfg, seed: int, workdir: Path) -> None:
    from asr_jax.cli import _build_session
    from asr_jax.parallel.llm_server import ContinuousSessionServer
    from asr_jax.parallel.mesh import make_mesh
    from asr_jax.runtime.whisper_session import WhisperSession, WhisperSessionConfig

    model_dir = write_sensevoice_artifact(workdir / "sensevoice", sv_cfg, seed)
    wavs = write_request_wavs(workdir, SERVE_REQUESTS, seed)
    one = [r.token_ids for r in map(_build_session(model_dir).transcribe, wavs)]
    for name, mesh, tp in (("data-parallel 4", make_mesh(4, model_parallel=1), 1),
                           ("dp 2 x tp 2", make_mesh(4, model_parallel=2), 2)):
        sess = _build_session(model_dir, mesh=mesh, tensor_parallel=tp)
        got = [sess.transcribe(p).token_ids for p in wavs]
        if got != one:
            raise AssertionError(f"sensevoice {name}: ids differ from one card")
        log(f"four-cards: sensevoice {name} ids == one card for {len(wavs)} requests")

    session = WhisperSession(
        whisper_q8(wh_cfg, seed), wh_cfg, window_seconds=WHISPER_WINDOW_S,
        session_cfg=WhisperSessionConfig(max_new_tokens=32, no_speech_threshold=None))
    pcm = [whisper_pcm(wh_cfg, seed, i) for i in range(4)]
    # the one-card solo run on the samples the server decodes from the WAV
    solo = [session.transcribe(p.astype(np.float32) / 32768.0).token_ids for p in pcm]
    srv = ContinuousSessionServer(session, n_slots=1, data_parallel=4)
    admitted = [0] * len(srv.replicas)
    for rep in srv.replicas:
        submit = rep.batcher.try_submit

        def counted(*a, _i=rep.index, _submit=submit, **kw):
            admitted[_i] += 1
            return _submit(*a, **kw)

        rep.batcher.try_submit = counted
    try:
        out: dict = {}

        def call(i):
            out[i] = srv.transcribe_bytes(wav_bytes(pcm[i], wh_cfg.sample_rate))

        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for rep in srv.replicas:
            devs = {d for leaf in jax.tree.leaves((rep.batcher.dec, rep.batcher.state))
                    for d in leaf.devices()}
            if devs != {rep.device}:
                raise AssertionError(f"replica {rep.index}: params/KV on {devs}, "
                                     f"not {rep.device}")
    finally:
        srv.close()
    if admitted != [1, 1, 1, 1]:
        raise AssertionError(f"requests per replica {admitted}, want one each")
    for i in range(4):
        if out[i]["token_ids"] != solo[i]:
            raise AssertionError(f"continuous dp4 request {i}: ids differ from one card")
    log("four-cards: whisper q8 serve --continuous --data-parallel 4: one request "
        "per replica, params and KV on the replica's own device, ids == one-card solo")


# ── main ───────────────────────────────────────────────────────────────────


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card paths and their one-card references")
    args = ap.parse_args(argv)

    info = device_phase(4 if args.four_cards else 1)
    enable_compile_cache()
    # Ids are compared across batch shapes (served vs direct, solo vs slots,
    # one card vs several). The shape changes XLA's choice of matmul
    # algorithm, and at the default precision (TF32 on the GPU) that alone
    # flips argmax ids of random weights; HIGHEST keeps the comparison about
    # the serving logic. Phase 3 reports both precisions explicitly.
    jax.config.update("jax_default_matmul_precision", "highest")
    from asr_jax.models.sensevoice import SenseVoiceConfig
    from asr_jax.models.whisper import WhisperConfig

    sv_cfg, wh_cfg = SenseVoiceConfig(), WhisperConfig()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        workdir = Path(tmp)
        if args.four_cards:
            four_card_phase(sv_cfg, wh_cfg, args.seed, workdir)
        else:
            serve_phase(sv_cfg, args.seed, workdir)
            numerics_phase(sv_cfg, args.seed)
            decode_phase(wh_cfg, args.seed)
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
