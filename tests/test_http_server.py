"""HTTP serving layer: WAV-bytes decode, micro-batched endpoint round trip,
health stats, malformed input, and the generalized per-family
transcribe_batch."""

import io
import json
import struct
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import jax

from asr_jax.parallel.http_server import SessionServer, decode_wav_bytes, start_background


class _Tok:
    def decode(self, ids):
        return " ".join(map(str, ids))


def _wav_bytes(samples: np.ndarray, rate: int = 16000) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.asarray(samples, np.int16).tobytes())
    return buf.getvalue()


def _sensevoice_session():
    from asr_jax.models import sensevoice as sv
    from asr_jax.runtime.session import SenseVoiceSession

    cfg = sv.SenseVoiceConfig(
        vocab_size=64, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
        num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5,
    )
    params = sv.init_params(cfg, jax.random.PRNGKey(0))
    return SenseVoiceSession(params, cfg, tokenizer=_Tok(), window_seconds=0.5)


def test_decode_wav_bytes_resamples_and_downmixes():
    rng = np.random.default_rng(0)
    stereo = (rng.standard_normal((800, 2)) * 1000).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes(stereo.tobytes())
    mono = decode_wav_bytes(buf.getvalue(), 16000)
    assert mono.ndim == 1 and abs(len(mono) - 1600) <= 2
    with pytest.raises(Exception):
        decode_wav_bytes(b"not a wav", 16000)


def test_http_round_trip_and_batching():
    sess = _sensevoice_session()
    httpd, srv, thread = start_background(sess, port=0, max_batch=4, max_wait_ms=15.0)
    port = httpd.server_address[1]
    base = f"http://127.0.0.1:{port}"
    try:
        rng = np.random.default_rng(1)
        wav = _wav_bytes((rng.standard_normal(4000) * 2000))

        # Reference output through the plain session path.
        pcm = np.frombuffer(wav[44:], np.int16).astype(np.float32)
        want = sess.transcribe(pcm).token_ids

        def post(path, data):
            req = urllib.request.Request(base + path, data=data, method="POST")
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, json.loads(resp.read())

        # Concurrent requests coalesce into one dispatch (same audio).
        results = [None] * 3
        def worker(i):
            results[i] = post("/transcribe", wav)
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for status, payload in results:
            assert status == 200
            assert payload["token_ids"] == want

        with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
            health = json.loads(resp.read())
        assert health["ok"] and health["requests_served"] >= 4  # incl. warmup
        assert health["batches_dispatched"] <= 4  # warmup + coalesced traffic
        assert health["batch_latency_avg_s"] > 0

        # Malformed audio -> 400, server stays alive.
        req = urllib.request.Request(base + "/transcribe", data=b"junk", method="POST")
        try:
            urllib.request.urlopen(req, timeout=10)
            assert False, "expected HTTPError"
        except urllib.error.HTTPError as e:
            assert e.code == 400
        status, payload = post("/transcribe", wav)
        assert status == 200 and payload["token_ids"] == want
    finally:
        httpd.shutdown()
        srv.close()


def test_windowed_transcribe_batch_matches_individual(tmp_path):
    """transcribe_batch on a windowed family == per-file transcribe."""
    from asr_jax.frontend.nemo_mel import NemoMelConfig
    from asr_jax.models import parakeet as pk
    from asr_jax.runtime.transducer_session import ParakeetSession

    cfg = pk.ParakeetConfig(
        vocab_size=40, blank_id=39, d_model=64, num_layers=1, num_heads=4,
        ffn_dim=96, conv_kernel=9, sub_channels=16, dec_hidden=32,
        mel=NemoMelConfig(n_mels=80),
    )
    params = pk.init_params(cfg, jax.random.PRNGKey(0))
    sess = ParakeetSession(params, cfg, tokenizer=_Tok(), window_seconds=0.5)
    rng = np.random.default_rng(2)
    paths = []
    for i in range(3):
        p = tmp_path / f"a{i}.wav"
        samples = (rng.standard_normal(4000 + 800 * i) * 2000).astype(np.int16)
        with wave.open(str(p), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(samples.tobytes())
        paths.append(str(p))
    batch = sess.transcribe_batch(paths)
    for p, r in zip(paths, batch):
        assert r.token_ids == sess.transcribe(p).token_ids
        assert r.batch_size in (1, 3)


def test_overlength_request_window_splits_into_batcher():
    """A request longer than one batching window must window-split INTO the
    micro-batcher (windows are just more batch rows) with the transcript
    identical to the session's own sliding-window path — not truncate, and
    not fall back to a serial non-batched path."""
    sess = _sensevoice_session()
    srv = SessionServer(sess, max_batch=4, max_wait_ms=1.0, warmup=False)
    try:
        rng = np.random.default_rng(1)
        long = (rng.standard_normal(3 * srv.window) * 1000).astype(np.int16)
        want = sess.transcribe(long.astype(np.float32))
        before = srv.batcher.batches_dispatched
        out = srv.transcribe_bytes(_wav_bytes(long))
        assert out.get("windows") == 3
        assert out["token_ids"] == want.token_ids
        assert abs(out["audio_seconds"] - len(long) / 16000.0) < 1e-6
        # all 3 windows coalesced into micro-batch dispatch(es)
        assert srv.batcher.batches_dispatched >= before + 1
        assert srv.batcher.requests_served >= 3
    finally:
        srv.close()


def test_overlength_llm_request_chunks_not_truncates():
    """LLM sessions have no sliding path of their own; the server's chunked
    path must still transcribe past the first window (regression: the old
    session.transcribe fallback silently truncated at max_samples while
    reporting windows=sliding)."""
    from asr_jax.layers import qwen3
    from asr_jax.models import qwen_asr as qa
    from asr_jax.runtime.qwen_session import QwenAsrSession, QwenPromptTemplate

    lcfg = qwen3.Qwen3Config(vocab_size=120, hidden=48, num_layers=1, num_heads=4,
                             num_kv_heads=2, head_dim=16, ffn_dim=64, rope_theta=1e4)
    cfg = qa.QwenAsrConfig(
        n_mels=16, tower_dim=32, tower_layers=1, tower_heads=4, tower_ffn=48,
        downsample_hidden=8, chunks_per_window=2, output_dim=lcfg.hidden, llm=lcfg, eot_id=-1,
    )
    tower = qa.init_tower_params(cfg, jax.random.PRNGKey(0))
    llm = qwen3.init_params(lcfg, jax.random.PRNGKey(1))
    sess = QwenAsrSession(tower, llm, cfg, tokenizer=_Tok(),
                          template=QwenPromptTemplate(head_ids=(1, 2), tail_ids=(4,)),
                          max_new_tokens=3, max_seconds=0.5)
    srv = SessionServer(sess, max_batch=4, max_wait_ms=1.0, warmup=False)
    try:
        rng = np.random.default_rng(3)
        long = (rng.standard_normal(2 * srv.window) * 900).astype(np.int16)
        out = srv.transcribe_bytes(_wav_bytes(long))
        assert out.get("windows") == 2
        # per-chunk ids concatenated == two direct single-window calls
        want = []
        for i in range(2):
            chunk = long[i * srv.window : (i + 1) * srv.window].astype(np.float32) / 32768.0
            want.extend(sess.transcribe(chunk).token_ids)
        assert out["token_ids"] == want

        # EVERY window's "language X<asr_text>" prefix must be stripped —
        # decode+postprocess runs per window, not once over concatenated ids
        class _TagTok:
            def decode(self, ids):
                return "language Chinese<asr_text>w" + str(len(ids))

        sess.tokenizer = _TagTok()
        out = srv.transcribe_bytes(_wav_bytes(long))
        assert "<asr_text>" not in out["text"] and "language" not in out["text"], out["text"]
    finally:
        srv.close()


def test_server_language_forwarded_to_forward():
    """serve --language must reach the session's batch forward (it was
    silently dropped for SenseVoice)."""
    sess = _sensevoice_session()
    seen = {}
    orig = sess._forward

    def spy(params, audio, valid, language="auto"):
        seen["language"] = language
        return orig(params, audio, valid, language=language)

    sess._forward = spy
    srv = SessionServer(sess, max_batch=1, max_wait_ms=1.0, warmup=False,
                        language="zh")
    try:
        short = np.zeros(srv.window // 2, np.int16)
        srv.transcribe_bytes(_wav_bytes(short))
        assert seen["language"] == "zh"
    finally:
        srv.close()


def test_session_server_qwen_llm_roundtrip():
    """The micro-batched server now serves the LLM family too: QwenAsrSession
    exposes the (B, W) -> (generated tokens, counts) surface (batched
    left-padded lockstep decode), so two concurrent requests coalesce into
    one device dispatch and decode to the same text as direct calls."""
    from asr_jax.layers import qwen3
    from asr_jax.models import qwen_asr as qa
    from asr_jax.runtime.qwen_session import QwenAsrSession, QwenPromptTemplate

    lcfg = qwen3.Qwen3Config(vocab_size=120, hidden=48, num_layers=1, num_heads=4,
                             num_kv_heads=2, head_dim=16, ffn_dim=64, rope_theta=1e4)
    cfg = qa.QwenAsrConfig(
        n_mels=16, tower_dim=32, tower_layers=1, tower_heads=4, tower_ffn=48,
        downsample_hidden=8, chunks_per_window=2, output_dim=lcfg.hidden, llm=lcfg, eot_id=-1,
    )
    tower = qa.init_tower_params(cfg, jax.random.PRNGKey(0))
    llm = qwen3.init_params(lcfg, jax.random.PRNGKey(1))
    sess = QwenAsrSession(tower, llm, cfg, tokenizer=_Tok(),
                          template=QwenPromptTemplate(head_ids=(1, 2), tail_ids=(4,)),
                          max_new_tokens=3, max_seconds=1.0)
    server = SessionServer(sess, max_batch=2, max_wait_ms=30.0, warmup=True)
    rng = np.random.default_rng(2)
    pcm = [(rng.standard_normal(8000) * 900).astype(np.int16) for _ in range(2)]
    want = [sess.transcribe(p.astype(np.float32) / 32768.0) for p in pcm]

    outs = [None, None]

    def call(i):
        outs[i] = server.transcribe_bytes(_wav_bytes(pcm[i]))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(2):
        assert outs[i]["token_ids"] == want[i].token_ids
        assert outs[i]["text"] == sess._postprocess(_Tok().decode(want[i].token_ids))
    assert server.batcher.requests_served == 3  # warmup + 2
    server.batcher.close()


def test_session_server_forwards_language_to_qwen():
    """serve --language must change the Qwen prompt (regression: _forward
    had no language parameter, so the server's signature check silently
    dropped the flag and every request auto-detected)."""
    from asr_jax.layers import qwen3
    from asr_jax.models import qwen_asr as qa
    from asr_jax.runtime.qwen_session import QwenAsrSession, QwenPromptTemplate

    lcfg = qwen3.Qwen3Config(vocab_size=120, hidden=48, num_layers=1, num_heads=4,
                             num_kv_heads=2, head_dim=16, ffn_dim=64, rope_theta=1e4)
    cfg = qa.QwenAsrConfig(
        n_mels=16, tower_dim=32, tower_layers=1, tower_heads=4, tower_ffn=48,
        downsample_hidden=8, chunks_per_window=2, output_dim=lcfg.hidden, llm=lcfg, eot_id=-1,
    )
    tower = qa.init_tower_params(cfg, jax.random.PRNGKey(0))
    llm = qwen3.init_params(lcfg, jax.random.PRNGKey(1))
    sess = QwenAsrSession(tower, llm, cfg, tokenizer=_Tok(),
                          template=QwenPromptTemplate(head_ids=(1, 2), tail_ids=(4,)),
                          max_new_tokens=3, max_seconds=0.5,
                          language_prompt_ids={"zh": [7, 8]})
    seen = {}
    orig = sess._prompt_ids

    def spy(context, language=None):
        seen["language"] = language
        return orig(context, language)

    sess._prompt_ids = spy
    server = SessionServer(sess, max_batch=1, max_wait_ms=5.0, warmup=True,
                           language="zh")
    assert seen["language"] == "zh"
    # unknown language fails loudly at construction instead of silently
    sess2 = QwenAsrSession(tower, llm, cfg, tokenizer=_Tok(),
                           max_new_tokens=3, max_seconds=0.5)
    with pytest.raises(KeyError):
        SessionServer(sess2, max_batch=1, warmup=True, language="zh")
    server.batcher.close()


def test_join_window_texts_boundaries():
    """Multi-window LLM transcripts: space inserted between ASCII word
    boundaries, never inside CJK text, never doubled around punctuation."""
    from asr_jax.parallel.http_server import _join_window_texts

    assert _join_window_texts(["meeting today", "The next item"]) == \
        "meeting today The next item"
    assert _join_window_texts(["你好世界", "今天天气"]) == "你好世界今天天气"
    assert _join_window_texts(["ends here.", "Next"]) == "ends here.Next"
    assert _join_window_texts(["", "only"]) == "only"
    assert _join_window_texts(["mixed 中文", "tail"]) == "mixed 中文tail"
    assert _join_window_texts(["abc", "123"]) == "abc 123"


def test_lockstep_surface_rejects_seed_param():
    """The lockstep micro-batcher shares one decode dispatch across
    requests, so a per-request seed cannot be honored — ``?seed=`` must
    fail loudly (HTTP 400) instead of being silently ignored."""
    sess = _sensevoice_session()
    httpd, srv, thread = start_background(sess, port=0, max_batch=2,
                                          max_wait_ms=5.0)
    port = httpd.server_address[1]
    try:
        wav = _wav_bytes(np.zeros(2000, np.float32))
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/transcribe?seed=3",
            data=wav, method="POST")
        try:
            urllib.request.urlopen(req, timeout=30)
            raise AssertionError("expected HTTP 400")
        except urllib.error.HTTPError as e:
            assert e.code == 400
            assert "seed" in json.loads(e.read())["error"]
    finally:
        httpd.shutdown()
        srv.close()
