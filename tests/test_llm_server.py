"""Continuous-batching serving surface: per-request output must be
token-identical to the session's own transcribe (which is itself parity-
tested against the lockstep decode), concurrent requests ride one running
batch, long audio window-chunks, health stats report the engine, and the
CLI flag routes correctly."""

import io
import json
import threading
import urllib.request
import wave

import numpy as np
import jax
import pytest

from asr_jax.parallel.llm_server import (
    ContinuousSessionServer, start_background_continuous)


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


def _qwen_session(max_new_tokens=4, max_seconds=0.5):
    from asr_jax.layers import qwen3
    from asr_jax.models import qwen_asr as qa
    from asr_jax.runtime.qwen_session import QwenAsrSession, QwenPromptTemplate

    lcfg = qwen3.Qwen3Config(vocab_size=120, hidden=48, num_layers=1,
                             num_heads=4, num_kv_heads=2, head_dim=16,
                             ffn_dim=64, rope_theta=1e4)
    cfg = qa.QwenAsrConfig(
        n_mels=16, tower_dim=32, tower_layers=1, tower_heads=4, tower_ffn=48,
        downsample_hidden=8, chunks_per_window=2, output_dim=lcfg.hidden,
        llm=lcfg, eot_id=-1,
    )
    tower = qa.init_tower_params(cfg, jax.random.PRNGKey(0))
    llm = qwen3.init_params(lcfg, jax.random.PRNGKey(1))
    return QwenAsrSession(tower, llm, cfg, tokenizer=_Tok(),
                          template=QwenPromptTemplate(head_ids=(1, 2), tail_ids=(4,)),
                          max_new_tokens=max_new_tokens,
                          max_seconds=max_seconds)


def test_prompt_embeds_matches_forward_front_half():
    """Session.prompt_embeds == the front half of the proven qa.forward
    path (same audio, same prompt)."""
    from asr_jax.models import qwen_asr as qa
    import jax.numpy as jnp

    sess = _qwen_session()
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(5000) * 0.02).astype(np.float32)
    emb, valid = sess.prompt_embeds(audio)

    buf = np.zeros((1, sess.max_samples), np.float32)
    buf[0, : len(audio)] = audio
    prompt = sess._prompt_ids("", None)
    want, want_valid = qa.prompt_embeds(
        sess.tower_params, sess.llm_params, sess.cfg, jnp.asarray(buf),
        jnp.asarray([len(audio)], jnp.int32), prompt)
    np.testing.assert_allclose(np.asarray(emb), np.asarray(want)[0],
                               rtol=1e-5, atol=1e-6)
    assert valid == int(want_valid[0])


def test_continuous_server_matches_session_concurrent():
    """Three concurrent requests decode to the same ids as direct
    session.transcribe calls, riding one continuous batch."""
    sess = _qwen_session()
    srv = ContinuousSessionServer(sess, n_slots=2, warmup=True)
    try:
        rng = np.random.default_rng(2)
        pcm = [(rng.standard_normal(6000) * 900).astype(np.int16)
               for _ in range(3)]
        want = [sess.transcribe(p.astype(np.float32) / 32768.0) for p in pcm]

        outs = [None] * 3

        def call(i):
            outs[i] = srv.transcribe_bytes(_wav_bytes(pcm[i]))

        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(3):
            assert outs[i]["token_ids"] == want[i].token_ids, i
            assert outs[i]["engine"] == "continuous"
        st = srv.stats()
        assert st["engine"] == "continuous"
        assert st["requests_served"] == 3
        assert st["tokens_generated"] >= 3
        assert st["slots_active"] == 0 and st["queue_depth"] == 0
    finally:
        srv.close()


def test_continuous_server_data_parallel_identity():
    """--continuous --data-parallel 2 (replica-per-device scale-out,
    VERDICT r3 item 6): two batcher replicas on two virtual devices behind
    one admission queue must produce ids identical to direct solo
    session.transcribe for every request, with both replicas live."""
    assert len(jax.devices()) >= 2  # conftest forces 8 virtual CPU devices
    sess = _qwen_session()
    srv = ContinuousSessionServer(sess, n_slots=1, warmup=True,
                                  data_parallel=2)
    try:
        st = srv.stats()
        assert st["replicas"] == 2 and st["slots"] == 2
        assert {r.device for r in srv.replicas} == set(jax.devices()[:2])

        rng = np.random.default_rng(7)
        pcm = [(rng.standard_normal(6000) * 900).astype(np.int16)
               for _ in range(5)]
        want = [sess.transcribe(p.astype(np.float32) / 32768.0) for p in pcm]

        outs = [None] * len(pcm)

        def call(i):
            outs[i] = srv.transcribe_bytes(_wav_bytes(pcm[i]))

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(pcm))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(len(pcm)):
            assert outs[i]["token_ids"] == want[i].token_ids, i
        st = srv.stats()
        assert st["requests_served"] == len(pcm)
        assert st["slots_active"] == 0 and st["queue_depth"] == 0
    finally:
        srv.close()


def test_continuous_server_chunks_long_audio():
    """Over-window audio splits into window requests; concatenated ids
    equal per-window session calls; per-window postprocess strips every
    window's language tag."""
    sess = _qwen_session()
    srv = ContinuousSessionServer(sess, n_slots=2, warmup=False)
    try:
        rng = np.random.default_rng(3)
        long = (rng.standard_normal(2 * srv.window) * 900).astype(np.int16)
        out = srv.transcribe_bytes(_wav_bytes(long))
        assert out.get("windows") == 2
        want = []
        for i in range(2):
            chunk = long[i * srv.window: (i + 1) * srv.window]
            want.extend(sess.transcribe(chunk.astype(np.float32) / 32768.0).token_ids)
        assert out["token_ids"] == want

        class _TagTok:
            def decode(self, ids):
                return "language Chinese<asr_text>w" + str(len(ids))

        sess.tokenizer = _TagTok()
        out = srv.transcribe_bytes(_wav_bytes(long))
        assert "<asr_text>" not in out["text"] and "language" not in out["text"]
    finally:
        srv.close()


def test_continuous_http_round_trip():
    sess = _qwen_session()
    httpd, srv, thread = start_background_continuous(sess, port=0, n_slots=2,
                                                     warmup=False)
    port = httpd.server_address[1]
    base = f"http://127.0.0.1:{port}"
    try:
        rng = np.random.default_rng(4)
        pcm = (rng.standard_normal(5000) * 800).astype(np.int16)
        want = sess.transcribe(pcm.astype(np.float32) / 32768.0)
        req = urllib.request.Request(f"{base}/transcribe",
                                     data=_wav_bytes(pcm), method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = json.loads(resp.read())
        assert out["token_ids"] == want.token_ids
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as resp:
            health = json.loads(resp.read())
        assert health["engine"] == "continuous" and health["ok"]
    finally:
        httpd.shutdown()
        srv.close()


def test_fun_asr_nano_llm_continuous_surface():
    """FunAsrNanoLlmSession exposes the same continuous surface; output
    matches its own transcribe."""
    from asr_jax.layers import qwen3
    from asr_jax.models import fun_asr_nano as fn
    from asr_jax.runtime.qwen_session import (FunAsrNanoLlmSession,
                                              QwenPromptTemplate)

    lcfg = qwen3.Qwen3Config(vocab_size=96, hidden=48, num_layers=1,
                             num_heads=4, num_kv_heads=2, head_dim=16,
                             ffn_dim=64, rope_theta=1e4)
    cfg = fn.FunAsrNanoConfig(
        hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
        num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5,
        adaptor_hidden=lcfg.hidden, adaptor_blocks=1, adaptor_heads=4,
        adaptor_ffn=64, ctc_hidden=32, ctc_blocks=1, ctc_heads=4, ctc_ffn=48,
        ctc_vocab=50, llm=lcfg, eot_id=-1,
    )
    params = fn.init_params(cfg, jax.random.PRNGKey(0))
    llm = qwen3.init_params(lcfg, jax.random.PRNGKey(1))
    sess = FunAsrNanoLlmSession(params, llm, cfg, tokenizer=_Tok(),
                                template=QwenPromptTemplate(head_ids=(1,),
                                                            tail_ids=(3,)),
                                max_new_tokens=3, max_seconds=0.4)
    rng = np.random.default_rng(5)
    pcm = (rng.standard_normal(4000) * 900).astype(np.float32)
    want = sess.transcribe(pcm)
    srv = ContinuousSessionServer(sess, n_slots=1, warmup=False)
    try:
        out = srv.transcribe_bytes(_wav_bytes(pcm.astype(np.int16)))
        assert out["token_ids"] == want.token_ids
    finally:
        srv.close()


def test_continuous_rejects_non_llm_session():
    class _NotLlm:
        pass

    with pytest.raises(TypeError):
        ContinuousSessionServer(_NotLlm())


def test_cli_serve_continuous_rejects_non_llm(tmp_path, monkeypatch):
    """serve --continuous on a non-LLM artifact exits with a clear error
    instead of crashing in the engine."""
    from asr_jax import cli

    sess = object.__new__(type("S", (), {}))  # no prompt_embeds

    monkeypatch.setattr(cli, "_build_session",
                        lambda *a, **k: sess)
    monkeypatch.setattr(cli, "_mesh_from_args", lambda args: (None, 1))
    args = type("A", (), dict(model_dir=str(tmp_path), language=None,
                              continuous=True, slots=2, context="",
                              host="127.0.0.1", port=0))()
    with pytest.raises(SystemExit, match="continuous"):
        cli.cmd_serve(args)


def test_continuous_server_steps_per_tick_identity():
    """steps_per_tick=3: same ids as direct session.transcribe, served
    concurrently; /healthz reports the tick width."""
    sess = _qwen_session()
    srv = ContinuousSessionServer(sess, n_slots=2, warmup=True,
                                  steps_per_tick=3)
    try:
        rng = np.random.default_rng(7)
        pcm = [(rng.standard_normal(6000) * 900).astype(np.int16)
               for _ in range(3)]
        want = [sess.transcribe(p.astype(np.float32) / 32768.0) for p in pcm]
        outs = [None] * 3

        def call(i):
            outs[i] = srv.transcribe_bytes(_wav_bytes(pcm[i]))

        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(3):
            assert outs[i]["token_ids"] == want[i].token_ids, i
        st = srv.stats()
        assert st["steps_per_tick"] == 3
        assert st["requests_served"] == 3
    finally:
        srv.close()


def test_continuous_server_tensor_parallel_identity():
    """--continuous --tensor-parallel 2 --data-parallel 2 (4 virtual
    devices): concurrent requests across TP replicas return the same ids
    as direct session.transcribe; /healthz reports the composition."""
    sess = _qwen_session()
    srv = ContinuousSessionServer(sess, n_slots=2, warmup=True,
                                  data_parallel=2, tensor_parallel=2)
    try:
        assert all(r.batcher.mesh is not None for r in srv.replicas)
        rng = np.random.default_rng(13)
        pcm = [(rng.standard_normal(6000) * 900).astype(np.int16)
               for _ in range(4)]
        want = [sess.transcribe(p.astype(np.float32) / 32768.0) for p in pcm]
        outs = [None] * 4

        def call(i):
            outs[i] = srv.transcribe_bytes(_wav_bytes(pcm[i]))

        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(4):
            assert outs[i]["token_ids"] == want[i].token_ids, i
        st = srv.stats()
        assert st["tensor_parallel"] == 2
        assert st["replicas"] == 2
        assert st["requests_served"] == 4
    finally:
        srv.close()


def test_http_seed_param_routes_to_continuous_engine():
    """``POST /transcribe?seed=N`` parses and reaches the continuous
    engine's per-request PRNG reseed (determinism under sampling is
    exercised at the batcher level, ``test_llm_batcher.py``); under the
    greedy default the seed is a no-op and output still matches solo."""
    sess = _qwen_session()
    httpd, srv, thread = start_background_continuous(sess, port=0, n_slots=2,
                                                     warmup=False)
    port = httpd.server_address[1]
    try:
        rng = np.random.default_rng(5)
        pcm = (rng.standard_normal(5000) * 800).astype(np.int16)
        want = sess.transcribe(pcm.astype(np.float32) / 32768.0)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/transcribe?seed=7",
            data=_wav_bytes(pcm), method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            out = json.loads(resp.read())
        assert out["token_ids"] == want.token_ids
    finally:
        httpd.shutdown()
        srv.close()
