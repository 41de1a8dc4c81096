"""Streaming-over-the-network surface: concurrent chunked-HTTP connections
mapped to vmapped stream slots must emit token-identical output to
sequential single-stream sessions; masked ticks must not advance idle
streams; /healthz reports per-tick latency."""

import json
import threading
import urllib.request

import numpy as np
import jax

from asr_jax.models import paraformer as pf
from asr_jax.runtime.streaming_session import ParaformerStreamingSession
from asr_jax.streaming import multistream as ms
from asr_jax.streaming import paraformer_online as po
from asr_jax.parallel.stream_server import (
    start_stream_background, stream_pcm_over_http,
)

TINY_BASE = pf.ParaformerConfig(
    vocab_size=50, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
    num_encoders0=1, num_encoders=1, num_decoders=1, num_decoder_ffn=1,
    fsmn_kernel=5, predictor_kernel=3,
)
TINY = po.ParaformerStreamConfig(base=TINY_BASE, chunk_samples=8000)


def _pcm(seed, chunks=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(chunks * TINY.chunk_samples) * 2000).astype(np.int16)


def _sequential_ids(params, pcm: np.ndarray) -> list[list[int]]:
    sess = ParaformerStreamingSession(params, TINY)
    out = []
    c = TINY.chunk_samples
    for i in range(len(pcm) // c):
        out.append(sess.push_chunk(pcm[i * c:(i + 1) * c].astype(np.float32)))
    return [ids for ids in out if ids]


def test_concurrent_streams_token_identical_to_sequential():
    params = pf.init_params(TINY_BASE, jax.random.PRNGKey(0))
    runner = ms.paraformer_multistream(params, TINY, 4)
    httpd, srv, _ = start_stream_background(runner, TINY.chunk_samples,
                                            tick_wait_ms=40.0)
    port = httpd.server_address[1]
    try:
        pcms = [_pcm(seed) for seed in range(3)]
        want = [_sequential_ids(params, p) for p in pcms]

        results = [None] * 3

        def client(i):
            results[i] = stream_pcm_over_http("127.0.0.1", port, pcms[i],
                                              send_chunk=4096)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i in range(3):
            evs = results[i]
            assert evs and evs[-1].get("done"), evs
            got = [e["ids"] for e in evs if "ids" in e]
            assert got == want[i], (i, got, want[i])
            # incremental: emitted across MULTIPLE ticks, not one flush
            ticks = [e["tick"] for e in evs if "ids" in e]
            assert ticks == sorted(ticks)

        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["ticks"] >= 3
        assert health["tick_latency_avg_s"] > 0
        assert health["slots_active"] == 0  # all released on disconnect
    finally:
        httpd.shutdown()
        srv.close()


def test_slot_reuse_and_exhaustion():
    params = pf.init_params(TINY_BASE, jax.random.PRNGKey(0))
    runner = ms.paraformer_multistream(params, TINY, 1)  # single slot
    httpd, srv, _ = start_stream_background(runner, TINY.chunk_samples,
                                            tick_wait_ms=10.0)
    port = httpd.server_address[1]
    try:
        pcm = _pcm(7, chunks=2)
        want = _sequential_ids(params, pcm)
        # two sequential connections on the SAME slot: per-connect reset
        # means the second stream restarts cleanly
        for _ in range(2):
            evs = stream_pcm_over_http("127.0.0.1", port, pcm, send_chunk=8192)
            got = [e["ids"] for e in evs if "ids" in e]
            assert got == want
    finally:
        httpd.shutdown()
        srv.close()


def test_masked_tick_leaves_idle_stream_state_untouched():
    """runner.step(active=...) must not advance masked slots' caches."""
    params = pf.init_params(TINY_BASE, jax.random.PRNGKey(0))
    runner = ms.paraformer_multistream(params, TINY, 2)
    a0 = _pcm(1, chunks=2).astype(np.float32)
    a1 = _pcm(2, chunks=2).astype(np.float32)
    c = TINY.chunk_samples

    # stream 0 advances twice; stream 1 only on the first and third tick
    out1 = runner.step(np.stack([a0[:c], a1[:c]]))
    runner.step(np.stack([a0[c:2 * c], np.zeros(c, np.float32)]),
                active=np.array([True, False]))
    out3 = runner.step(np.stack([a0[:c], a1[c:2 * c]]),
                       active=np.array([False, True]))

    sess = ParaformerStreamingSession(params, TINY)
    w1 = sess.push_chunk(a1[:c])
    w2 = sess.push_chunk(a1[c:2 * c])
    got1 = [int(t) for t in np.asarray(out1["ids"])[1, : int(out1["count"][1])]]
    got2 = [int(t) for t in np.asarray(out3["ids"])[1, : int(out3["count"][1])]]
    assert got1 == w1 and got2 == w2


class _EchoRunner:
    """Fake runner recording every (slot, window) fed to it."""

    def __init__(self, n):
        self.n_streams = n
        self.windows = {i: [] for i in range(n)}
        self.resets = []

    def reset(self, i):
        self.resets.append(i)

    def step(self, chunks, active=None):
        import numpy as np
        ids = np.zeros((self.n_streams, 1), np.int32)
        count = np.zeros((self.n_streams,), np.int32)
        for i in range(self.n_streams):
            if active is None or active[i]:
                self.windows[i].append(chunks[i].copy())
                ids[i, 0] = len(self.windows[i])
                count[i] = 1
        return {"ids": ids, "count": count}


def test_overlapped_windows_match_session_geometry():
    """advance < chunk: every fed window must cover [t*adv, t*adv+chunk) of
    the stream (the single-stream sessions' geometry), the tail pad must be
    appended before draining, and drain_min must bound the last window."""
    from asr_jax.parallel.stream_server import StreamingServer
    import numpy as np

    chunk, adv, tail = 8, 4, 6
    runner = _EchoRunner(1)
    srv = StreamingServer(runner, chunk, tick_wait_ms=1.0,
                          advance_samples=adv, tail_pad_samples=tail,
                          drain_min_samples=chunk)
    try:
        i = srv.acquire()
        audio = np.arange(1, 15, dtype=np.float32)  # 14 samples
        srv.feed(i, audio)
        srv.finish_input(i)
        # padded stream = audio + 6 zeros = 20 samples; windows while a
        # full window fits: starts 0,4,8,12 (12+8=20)
        deadline = __import__("time").time() + 10
        while len(runner.windows[0]) < 4 and __import__("time").time() < deadline:
            __import__("time").sleep(0.02)
        ws = runner.windows[0]
        assert len(ws) == 4, [w.tolist() for w in ws]
        padded = np.concatenate([audio, np.zeros(tail, np.float32)])
        for t, w in enumerate(ws):
            np.testing.assert_array_equal(w, padded[t * adv: t * adv + chunk])
        assert runner.resets == [0]  # reset applied by the ticker exactly once
    finally:
        srv.close()


def test_ticker_survives_extract_exception():
    """A failing extract callback must not silently kill the ticker: the
    affected stream receives an {"error": ...} event and end-of-stream,
    /healthz flips ok=false with the error recorded, and a NEW stream
    still works afterwards (the ticker thread stays alive)."""
    params = pf.init_params(TINY_BASE, jax.random.PRNGKey(0))
    runner = ms.paraformer_multistream(params, TINY, 2)
    boom = {"armed": True}

    def extract(outs, i, st):
        if boom["armed"]:
            raise RuntimeError("synthetic extract failure")
        return [int(t) for t in np.asarray(outs["ids"][i])[
            : int(np.asarray(outs["count"][i]))]]

    httpd, srv, _ = start_stream_background(runner, TINY.chunk_samples,
                                            extract=extract, tick_wait_ms=10.0)
    port = httpd.server_address[1]
    try:
        evs = stream_pcm_over_http("127.0.0.1", port, _pcm(0), send_chunk=4096)
        assert any("error" in e for e in evs), evs
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            health = json.loads(r.read())
        assert health["ok"] is False
        assert "synthetic extract failure" in health["last_error"]

        boom["armed"] = False  # device/callback recovered
        evs2 = stream_pcm_over_http("127.0.0.1", port, _pcm(1), send_chunk=4096)
        assert evs2 and evs2[-1].get("done"), evs2
        assert any("ids" in e for e in evs2)
    finally:
        httpd.shutdown()
        srv.close()


def test_chunk_extension_size_line():
    """RFC 9112 chunk extensions can push the size line past any small
    readline cap; the server must still parse the frame correctly."""
    import socket as _socket

    params = pf.init_params(TINY_BASE, jax.random.PRNGKey(0))
    runner = ms.paraformer_multistream(params, TINY, 2)
    httpd, srv, _ = start_stream_background(runner, TINY.chunk_samples,
                                            tick_wait_ms=10.0)
    port = httpd.server_address[1]
    try:
        pcm = _pcm(0, chunks=1)
        want = _sequential_ids(pf.init_params(TINY_BASE, jax.random.PRNGKey(0)), pcm)
        data = np.asarray(pcm, "<i2").tobytes()
        sock = _socket.create_connection(("127.0.0.1", port), timeout=60)
        try:
            sock.sendall(b"POST /stream HTTP/1.1\r\nHost: x\r\n"
                         b"Transfer-Encoding: chunked\r\n\r\n")
            ext = b";name=" + b"v" * 100  # 100+-byte extension
            sock.sendall(f"{len(data):x}".encode() + ext + b"\r\n" + data + b"\r\n")
            sock.sendall(b"0\r\n\r\n")
            buf = b""
            while b"\r\n0\r\n\r\n" not in buf:
                piece = sock.recv(65536)
                if not piece:
                    break
                buf += piece
        finally:
            sock.close()
        text = buf.split(b"\r\n\r\n", 1)[1]
        assert b'"done"' in text
        got = [json.loads(ln)["ids"] for ln in
               _dechunk(text).decode().splitlines() if '"ids"' in ln]
        assert got == want, (got, want)
    finally:
        httpd.shutdown()
        srv.close()


def _dechunk(body: bytes) -> bytes:
    out = b""
    while body:
        line, _, rest = body.partition(b"\r\n")
        try:
            size = int(line.strip().split(b";")[0], 16)
        except ValueError:
            break
        if size == 0:
            break
        out += rest[:size]
        body = rest[size + 2:]
    return out


def test_ticks_per_sync_identical_token_stream():
    """ticks_per_sync=3 (K chunk ticks fused into one device dispatch,
    MultiStreamRunner.step_n): the SAME per-stream token stream as K=1,
    with fewer device syncs reported by /healthz."""
    params = pf.init_params(TINY_BASE, jax.random.PRNGKey(0))
    pcms = [_pcm(seed, chunks=6) for seed in range(2)]
    want = [_sequential_ids(params, p) for p in pcms]

    runner = ms.paraformer_multistream(params, TINY, 2)
    httpd, srv, _ = start_stream_background(runner, TINY.chunk_samples,
                                            tick_wait_ms=40.0,
                                            ticks_per_sync=3)
    port = httpd.server_address[1]
    try:
        results = [None] * 2

        def client(i):
            results[i] = stream_pcm_over_http("127.0.0.1", port, pcms[i],
                                              send_chunk=1 << 16)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i in range(2):
            evs = results[i]
            assert evs and evs[-1].get("done"), evs
            got = [e["ids"] for e in evs if "ids" in e]
            assert got == want[i], (i, got, want[i])

        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["ticks_per_sync"] == 3
        # 2 streams x 6 chunks = 12 stream-ticks over >= ceil(6/3)=2 syncs;
        # fused bursts must do strictly fewer syncs than ticks
        assert health["device_syncs"] < health["ticks"]
    finally:
        httpd.shutdown()


def test_extract_failure_stops_subticks_within_sync():
    """With ticks_per_sync > 1, a stream failed by its extract callback at
    one subtick must NOT be extracted again at the remaining subticks of
    the same sync: its out_q ends exactly error -> end-of-stream, with no
    stray events after the terminator, and its extractor state is not
    touched again (regression: the K>1 burst loop used to keep calling
    extract on a finished slot)."""
    params = pf.init_params(TINY_BASE, jax.random.PRNGKey(0))
    runner = ms.paraformer_multistream(params, TINY, 2)
    calls = []

    def extract(outs, i, st):
        calls.append(i)
        raise RuntimeError("always failing")

    httpd, srv, _ = start_stream_background(runner, TINY.chunk_samples,
                                            extract=extract, tick_wait_ms=10.0,
                                            ticks_per_sync=3)
    port = httpd.server_address[1]
    try:
        # one shot: all six chunks buffer before the burst gathers, so the
        # first sync really fuses multiple subticks of the failing stream
        evs = stream_pcm_over_http("127.0.0.1", port, _pcm(5, chunks=6),
                                   send_chunk=200_000)
        errs = [e for e in evs if "error" in e]
        assert len(errs) == 1, evs          # exactly one failure event
        assert not any("ids" in e for e in evs)
        # the failed stream was extracted once, never re-driven afterwards
        assert len(calls) == 1, calls
    finally:
        httpd.shutdown()
        srv.close()
