"""Continuous-batching HTTP serving for the LLM-decoder families.

The micro-batched ``SessionServer`` (``http_server.py``) coalesces
same-instant requests into one lockstep decode, but the lockstep call is a
BARRIER: late arrivals wait for the whole running batch to finish. This
server keeps ONE :class:`~asr_jax.parallel.llm_batcher.ContinuousLlmBatcher`
running and lets requests join and leave it mid-flight — the serving shape
of every production LLM runtime (the reference's
``Qwen_ASR/Inference_Qwen_ASR_ONNX.py`` loop is strictly batch-1 and
offline; continuous batching is this framework's addition).

Design: all device work happens on ONE driver thread (prefill via
``session.prompt_embeds`` + the batcher's step), so executables never race;
HTTP handler threads only enqueue requests and wait on per-request events.
Every admitted request starts decoding on the very next step; a finished
slot frees immediately for the next queued request.

Endpoints are identical to ``http_server.py`` (``POST /transcribe`` with a
WAV/FLAC/MP3 body, ``GET /healthz``) so clients don't care which engine a
deployment runs; ``/healthz`` additionally reports slot occupancy and
decode-step latency. Run via
``python -m asr_jax serve --model-dir M --continuous [--slots 8]``.
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np

from asr_jax.parallel.http_server import decode_audio_bytes, _join_window_texts
from asr_jax.parallel.llm_batcher import ContinuousLlmBatcher, _bucket
from asr_jax.runtime import audio as audio_io


class _Req:
    __slots__ = ("samples", "event", "ids", "error", "t_enqueue", "t_admit",
                 "seed")

    def __init__(self, samples: np.ndarray, seed: int | None = None):
        self.samples = samples
        self.event = threading.Event()
        self.ids: list[int] | None = None
        self.error: Exception | None = None
        self.t_enqueue = time.perf_counter()
        self.t_admit = 0.0
        # optional per-request PRNG seed: sampling strategies become
        # reproducible regardless of batching history (the batcher reseeds
        # the slot key from fold_in(base_key, seed) at insert)
        self.seed = seed


class _Replica:
    """One continuous decode engine pinned to one device: its own batcher,
    its own in-flight-request map, its own driver thread (the batcher's
    single-driver-thread contract holds per replica)."""

    __slots__ = ("index", "device", "batcher", "slot_req", "thread")

    def __init__(self, index, device, batcher):
        self.index = index
        self.device = device
        self.batcher = batcher
        self.slot_req: dict[int, _Req] = {}
        self.thread: threading.Thread | None = None


class ContinuousSessionServer:
    """Continuous decode batches behind an HTTP front end.

    ``session`` must expose the continuous-batching surface
    (``prompt_embeds``, ``llm_params``, ``llm_cfg``, ``decode_cfg``,
    ``window_samples`` — :class:`QwenAsrSession` and
    :class:`FunAsrNanoLlmSession`).

    Scale-out (``data_parallel=N``) is replica-per-device — the natural
    shape for a latency engine whose requests are independent: the LLM
    weights are copied to N devices, each device runs its own
    :class:`ContinuousLlmBatcher` (the exact single-chip engine) behind ONE
    shared admission queue, and replicas never
    communicate — linear throughput with zero collectives, unlike the
    lockstep path's sharded batches. Prompt embeds (audio tower) compute on
    the session's device and hop to the owning replica as one small
    host-staged copy per request (~L x H floats). Run the session itself
    UNSHARDED (no ``mesh=``).

    ``tensor_parallel=T`` composes: each replica then owns a T-device
    (1, T) sub-mesh and its batcher runs the GSPMD tensor-parallel step
    (Megatron weight shards + head-sharded KV). ``data_parallel``
    counts REPLICAS — ``data_parallel=2, tensor_parallel=4`` uses 8
    devices. Use TP when one chip can't hold the weights + KV, or to cut
    per-step latency on large models; per-request output stays identical.
    """

    def __init__(self, session, n_slots: int = 8, language: str | None = None,
                 context: str = "", warmup: bool = True,
                 kv_dtype: str = "f32", data_parallel: int = 1,
                 steps_per_tick: int = 1, tensor_parallel: int = 1):
        # Engine selection: AED families (Whisper / FireRed / Dolphin)
        # expose ``continuous_prefill`` (per-request encoder + prompt
        # prefill -> decode state); LLM families expose ``prompt_embeds``.
        self._aed = hasattr(session, "continuous_prefill")
        if not self._aed and not hasattr(session, "prompt_embeds"):
            raise TypeError(
                f"{type(session).__name__} has no continuous serving "
                "surface; continuous batching serves the LLM families "
                "(qwen_asr, fun_asr_nano --head llm) and the AED families "
                "(whisper, firered, dolphin)")
        self.session = session
        self._language = language
        self._context = context
        self.sample_rate = getattr(session, "sample_rate", 16000)
        self.pcm_scale = getattr(session, "pcm_scale", 32768.0)
        self.window = session.window_samples
        dc = session.decode_cfg

        import jax
        import jax.numpy as jnp

        if kv_dtype not in ("f32", "bf16"):
            raise ValueError(f"kv_dtype must be f32 or bf16, got {kv_dtype!r}")
        kvd = jnp.bfloat16 if kv_dtype == "bf16" else jnp.float32
        dp = max(int(data_parallel), 1)
        tp = max(int(tensor_parallel), 1)
        self.tensor_parallel = tp
        devices = jax.devices()
        if dp * tp > len(devices):
            raise ValueError(
                f"data_parallel={dp} x tensor_parallel={tp} needs {dp * tp} "
                f"devices but only {len(devices)} available")
        self.replicas: list[_Replica] = []
        if self._aed:
            if tp > 1:
                raise ValueError(
                    "--tensor-parallel does not compose with the AED "
                    "continuous engine (its decoders fit one chip; scale "
                    "out with --data-parallel replicas)")
            from asr_jax.parallel.aed_batcher import ContinuousAedBatcher

            spec = session.aed_engine_spec()
            probe = None
            for i in range(dp):
                dev = devices[i]
                params = (session.params if i == 0
                          else jax.device_put(session.params, dev))
                with jax.default_device(dev):
                    batcher = ContinuousAedBatcher(
                        params, spec, dc, n_slots=n_slots, kv_dtype=kvd,
                        steps_per_tick=steps_per_tick)
                self.replicas.append(_Replica(i, dev, batcher))
        else:
            # Probe the static prompt length L (audio pads to max_samples,
            # so L is the same for every request) and size the cache to one
            # prefill bucket + the generation budget.
            probe, _ = session.prompt_embeds(
                np.zeros(16, np.float32), context=context, language=language)
            t_max = _bucket(int(probe.shape[0])) + dc.max_new_tokens + 1
            for i in range(dp):
                if tp > 1:
                    # replica i owns a (1, tp) sub-mesh; the batcher shards
                    # the weights/KV itself (qwen3_param_specs) and GSPMD
                    # steps them
                    from jax.sharding import Mesh
                    sub = np.array(devices[i * tp:(i + 1) * tp]).reshape(1, tp)
                    batcher = ContinuousLlmBatcher(
                        session.llm_params, session.llm_cfg, dc,
                        n_slots=n_slots, t_max=t_max, kv_dtype=kvd,
                        steps_per_tick=steps_per_tick,
                        mesh=Mesh(sub, ("data", "model")))
                    self.replicas.append(_Replica(i, devices[i * tp], batcher))
                    continue
                dev = devices[i]
                # replicate the weights: plain dp, one copy per device
                params = (session.llm_params if i == 0
                          else jax.device_put(session.llm_params, dev))
                with jax.default_device(dev):
                    batcher = ContinuousLlmBatcher(
                        params, session.llm_cfg, dc, n_slots=n_slots,
                        t_max=t_max, kv_dtype=kvd,
                        steps_per_tick=steps_per_tick)
                self.replicas.append(_Replica(i, dev, batcher))
        self.batcher = self.replicas[0].batcher  # single-chip alias

        self._cv = threading.Condition()
        self._pending: collections.deque[_Req] = collections.deque()
        self._stop = False
        self._fatal: Exception | None = None
        self._pending_failed = False
        self._stats_lock = threading.Lock()
        self._requests_served = 0
        self._tokens_generated = 0
        self._steps = 0
        self._step_time = 0.0
        self._queue_wait_total = 0.0
        # prompt_embeds runs the session's jit from every replica driver;
        # serialize it (one audio tower, shared executable cache)
        self._embed_lock = threading.Lock()

        if warmup:
            # Compile prefill + insert + one decode step on EVERY replica
            # before the first real request (the first jit takes seconds).
            pre = (session.continuous_prefill(np.zeros(16, np.float32),
                                              language=language)
                   if self._aed else None)
            for rep in self.replicas:
                if self._aed:
                    small = (pre["state"] if rep.index == 0 else
                             jax.device_put(pre["state"], rep.device))
                    lg0 = (pre["logits0"] if rep.index == 0 else
                           jax.device_put(pre["logits0"], rep.device))
                    slot = rep.batcher.try_submit(small, pre["p_len"], lg0,
                                                  pre["tc_valid"])
                else:
                    # TP batchers re-place embeds onto their mesh themselves
                    emb = (probe
                           if rep.index == 0 or rep.batcher.mesh is not None
                           else jax.device_put(np.asarray(probe), rep.device))
                    slot = rep.batcher.try_submit(emb, 1)
                if rep.batcher.is_active(slot):
                    rep.batcher.step_tick()
                    rep.batcher.cancel(slot)
                else:
                    rep.batcher.take_result(slot)

        for rep in self.replicas:
            rep.thread = threading.Thread(target=self._drive, args=(rep,),
                                          daemon=True)
            rep.thread.start()

    # ── driver threads: ONE per replica (the only thread touching its
    #    device state) ───────────────────────────────────────────────────────
    def _drive(self, rep: _Replica) -> None:
        try:
            while True:
                with self._cv:
                    while (not self._stop and not self._pending
                           and not rep.slot_req):
                        self._cv.wait(timeout=0.2)
                    if self._stop:
                        self._fail_replica(rep,
                                           RuntimeError("server shut down"))
                        return
                    admit = []
                    while (self._pending
                           and len(admit) + len(rep.slot_req) < rep.batcher.n_slots):
                        admit.append(self._pending.popleft())
                for req in admit:
                    self._admit(rep, req)
                t0 = time.perf_counter()
                events = rep.batcher.step_tick()
                if events:
                    dt = time.perf_counter() - t0
                    # count only substeps that advanced >= 1 active slot —
                    # trailing all-parked scan iterations of a tick are
                    # no-ops and would inflate decode_steps
                    k = rep.batcher.last_tick_substeps
                    with self._stats_lock:
                        self._steps += k
                        self._step_time += dt
                        self._tokens_generated += len(events)
                for slot, _tok, fin in events:
                    if fin:
                        self._finish(rep, slot)
        except Exception as exc:  # device OOM / XLA error: the engine is dead
            # Fail every pending AND in-flight request (their handler threads
            # block on event.wait() with no timeout), refuse new submissions,
            # and surface the failure via /healthz (stats() reports ok: false).
            with self._cv:
                self._stop = True
                self._fatal = exc
                self._fail_replica(rep, exc)
                self._cv.notify_all()  # wake sibling drivers to fail theirs

    def _fail_replica(self, rep: _Replica, exc: Exception) -> None:
        """Fail the shared queue (once) and THIS replica's admitted
        requests; sibling replicas fail their own when they observe
        ``_stop``. Caller holds ``_cv``."""
        if not self._pending_failed:
            self._pending_failed = True
            for req in self._pending:
                req.error = exc
                req.event.set()
            self._pending.clear()
        for req in rep.slot_req.values():
            req.error = exc
            req.event.set()
        rep.slot_req.clear()

    def _admit(self, rep: _Replica, req: _Req) -> None:
        try:
            if self._aed:
                with self._embed_lock:
                    pre = self.session.continuous_prefill(
                        req.samples, language=self._language)
                if pre["skip"]:  # no-speech window: empty result, no slot
                    req.t_admit = time.perf_counter()
                    with self._stats_lock:
                        self._queue_wait_total += req.t_admit - req.t_enqueue
                    req.ids = []
                    self._complete(req)
                    return
                small, lg0 = pre["state"], pre["logits0"]
                if rep.index != 0:
                    import jax

                    small = jax.device_put(small, rep.device)
                    lg0 = jax.device_put(lg0, rep.device)
                slot = rep.batcher.try_submit(small, pre["p_len"], lg0,
                                              pre["tc_valid"], seed=req.seed)
            else:
                with self._embed_lock:
                    embeds, valid = self.session.prompt_embeds(
                        req.samples, context=self._context,
                        language=self._language)
                if rep.index != 0 and rep.batcher.mesh is None:
                    import jax

                    embeds = jax.device_put(np.asarray(embeds), rep.device)
                slot = rep.batcher.try_submit(embeds, max(valid, 1),
                                              seed=req.seed)
        except Exception as exc:  # bad audio shape etc. — fail THIS request
            req.error = exc
            req.event.set()
            return
        if slot is None:  # raced a slot we accounted as free; retry next tick
            with self._cv:
                self._pending.appendleft(req)
                self._cv.notify_all()  # an idle sibling may own the free slot
            return
        req.t_admit = time.perf_counter()
        with self._stats_lock:
            self._queue_wait_total += req.t_admit - req.t_enqueue
        if not rep.batcher.is_active(slot):
            # first token was already EOT (or a budget of one): step() will
            # never report this slot — drain it here
            req.ids = rep.batcher.take_result(slot)
            self._complete(req)
        else:
            rep.slot_req[slot] = req

    def _finish(self, rep: _Replica, slot: int) -> None:
        ids = rep.batcher.take_result(slot)
        req = rep.slot_req.pop(slot, None)
        if req is None:  # cancelled (warmup / client gone)
            return
        req.ids = ids
        self._complete(req)

    def _complete(self, req: _Req) -> None:
        eot = self.session.decode_cfg.eot_id
        req.ids = [t for t in req.ids if t != eot]
        with self._stats_lock:
            self._requests_served += 1
        req.event.set()

    # ── handler-thread API ──────────────────────────────────────────────────
    def submit(self, samples: np.ndarray, seed: int | None = None) -> _Req:
        req = _Req(np.ascontiguousarray(samples, np.float32), seed=seed)
        with self._cv:
            if self._stop:
                raise (self._fatal or RuntimeError("server shut down"))
            self._pending.append(req)
            # notify_all: with data_parallel > 1 several replica drivers wait
            # on this condition — waking ONE can leave an idle replica asleep
            # until its 0.2 s wait timeout while another is mid-tick
            self._cv.notify_all()
        return req

    def transcribe_bytes(self, data: bytes, seed: int | None = None) -> dict:
        samples = decode_audio_bytes(data, self.sample_rate)
        if self.pcm_scale != 32768.0:
            samples = samples * np.float32(self.pcm_scale / 32768.0)
        n = len(samples)
        w = self.window
        starts = audio_io.iter_windows(n, w, w)
        # per-window derived seeds keep multi-window requests reproducible
        # while giving each window's decode an independent sample stream
        reqs = [self.submit(samples[s: s + w],
                            seed=None if seed is None else seed + k)
                for k, s in enumerate(starts)]
        ids: list[int] = []
        texts: list[str] = []
        tok = self.session.tokenizer
        per_window = bool(getattr(self.session, "postprocess_per_window", False))
        post = getattr(self.session, "_postprocess", lambda s: s)
        for req in reqs:
            req.event.wait()
            if req.error is not None:
                raise req.error
            ids.extend(req.ids)
            if tok and per_window:
                texts.append(post(tok.decode(req.ids)))
        if tok and not per_window:
            texts = [post(tok.decode(ids))]
        resp = {
            "text": _join_window_texts(texts),
            "token_ids": ids,
            "audio_seconds": n / self.sample_rate,
            "engine": "continuous",
        }
        if len(starts) > 1:
            resp["windows"] = len(starts)
        return resp

    def stats(self) -> dict:
        with self._stats_lock:
            served = self._requests_served
            steps = self._steps
            avg_step = self._step_time / steps if steps else 0.0
            toks = self._tokens_generated
            qwait = (self._queue_wait_total / served) if served else 0.0
        fatal = self._fatal
        return {
            "ok": fatal is None,
            **({"error": f"{type(fatal).__name__}: {fatal}"} if fatal else {}),
            "engine": "continuous",
            "decoder": "aed" if self._aed else "llm",
            "replicas": len(self.replicas),
            "tensor_parallel": self.tensor_parallel,
            "slots": sum(r.batcher.n_slots for r in self.replicas),
            "slots_active": sum(len(r.slot_req) for r in self.replicas),
            "queue_depth": len(self._pending),
            "requests_served": served,
            "decode_steps": steps,
            "tokens_generated": toks,
            "steps_per_tick": self.batcher.steps_per_tick,
            "step_latency_avg_s": round(avg_step, 5),
            "queue_wait_avg_s": round(qwait, 5),
            "window_samples": self.window,
            "sample_rate": self.sample_rate,
        }

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for rep in self.replicas:
            if rep.thread is not None:
                rep.thread.join(timeout=10)


def serve_continuous(session, host: str = "127.0.0.1", port: int = 8000,
                     n_slots: int = 8, language: str | None = None,
                     context: str = "", warmup: bool = True,
                     kv_dtype: str = "f32", data_parallel: int = 1,
                     steps_per_tick: int = 1, tensor_parallel: int = 1):
    """Blocking entry point used by ``serve --continuous``."""
    from asr_jax.parallel.http_server import make_http_server

    srv = ContinuousSessionServer(session, n_slots=n_slots, language=language,
                                  context=context, warmup=warmup,
                                  kv_dtype=kv_dtype,
                                  data_parallel=data_parallel,
                                  steps_per_tick=steps_per_tick,
                                  tensor_parallel=tensor_parallel)
    httpd = make_http_server(srv, host, port)
    print(f"serving on http://{host}:{httpd.server_address[1]} "
          f"(engine=continuous, slots={n_slots}"
          + (f" x {data_parallel} replicas" if data_parallel > 1 else "")
          + (f", tp={tensor_parallel}" if tensor_parallel > 1 else "")
          + ")")
    try:
        httpd.serve_forever()
    finally:
        srv.close()


def start_background_continuous(session, host: str = "127.0.0.1", port: int = 0,
                                n_slots: int = 8, language: str | None = None,
                                context: str = "", warmup: bool = True,
                                kv_dtype: str = "f32", data_parallel: int = 1,
                                steps_per_tick: int = 1,
                                tensor_parallel: int = 1):
    """Non-blocking start (tests / embedding): returns (httpd, server,
    thread); actual port in ``httpd.server_address[1]``."""
    from asr_jax.parallel.http_server import make_http_server

    srv = ContinuousSessionServer(session, n_slots=n_slots, language=language,
                                  context=context, warmup=warmup,
                                  kv_dtype=kv_dtype,
                                  data_parallel=data_parallel,
                                  steps_per_tick=steps_per_tick,
                                  tensor_parallel=tensor_parallel)
    httpd = make_http_server(srv, host, port)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, srv, thread
