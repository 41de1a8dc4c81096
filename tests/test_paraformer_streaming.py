"""Paraformer streaming: incremental CIF vs python reference, cache
rolling behavior, full chunked session."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from asr_jax.models import paraformer as pf
from asr_jax.streaming import paraformer_online as po
from asr_jax.runtime.streaming_session import ParaformerStreamingSession

TINY_BASE = pf.ParaformerConfig(
    vocab_size=50, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
    num_encoders0=1, num_encoders=1, num_decoders=1, num_decoder_ffn=1,
    fsmn_kernel=5, predictor_kernel=3,
)
TINY = po.ParaformerStreamConfig(base=TINY_BASE, chunk_samples=8000)


def python_cif_stream(alpha_chunks, hidden_chunks, d):
    """Reference-faithful per-step incremental CIF over chunks."""
    avg = np.zeros(d)
    a = 0.0
    out_frames, out_counts = [], []
    for alphas, hiddens in zip(alpha_chunks, hidden_chunks):
        frames_chunk = []
        # initial boundary step
        fire0 = a >= 1.0
        f0 = avg.copy() if fire0 else a * avg
        if fire0:
            frames_chunk.append(f0.copy())
            a -= 1.0
            f = a * avg
        else:
            f = f0
        for alpha, h in zip(alphas, hiddens):
            thr = 1.0 - a
            fire = alpha >= thr
            frame_out = f + (thr if fire else alpha) * h
            if fire:
                frames_chunk.append(frame_out.copy())
            a = a + alpha - (1.0 if fire else 0.0)
            f = a * h if fire else frame_out
        avg = f / max(a, 1e-9)
        out_frames.append(frames_chunk)
        out_counts.append(len(frames_chunk))
    return out_frames, out_counts


def test_incremental_cif_matches_python_reference():
    rng = np.random.default_rng(0)
    d, steps, chunks = 4, 9, 5
    alpha_chunks = [rng.uniform(0, 0.8, steps).astype(np.float32) for _ in range(chunks)]
    hidden_chunks = [rng.standard_normal((steps, d)).astype(np.float32) for _ in range(chunks)]
    ref_frames, ref_counts = python_cif_stream(alpha_chunks, hidden_chunks, d)

    avg = jnp.zeros((1, 1, d))
    alpha = jnp.zeros((1,))
    for c in range(chunks):
        frames, fires, avg, alpha = po._cif_chunk_scan(
            jnp.asarray(alpha_chunks[c]), jnp.asarray(hidden_chunks[c]), avg, alpha
        )
        count = int(jnp.sum(fires))
        assert count == ref_counts[c], c
        fired = np.asarray(frames)[np.asarray(fires)]
        for k in range(count):
            np.testing.assert_allclose(fired[k], ref_frames[c][k], rtol=1e-4, atol=1e-5)


def test_encoder_step_cache_rolls():
    params = pf.init_params(TINY_BASE, jax.random.PRNGKey(0))
    state = po.init_state(TINY, params)
    rng = np.random.default_rng(1)
    for i in range(5):
        chunk = jnp.asarray((rng.standard_normal((1, 8000)) * 2000).astype(np.float32))
        state, fired, count, enc = po.encoder_step(params, TINY, state, chunk)
        assert enc.shape == (1, TINY.chunk_positions, TINY_BASE.hidden)
        assert fired.shape == (1, TINY.max_fires, TINY_BASE.hidden)
        assert int(state["enc_valid"]) == min((i + 1) * TINY.look_back_b, TINY.enc_cache_len)
        assert int(state["start_idx"]) == (i + 1) * TINY.t_lfr
    assert state["enc_k"].shape == (2, TINY.enc_cache_len, 4, 8)


def test_decoder_step_updates_caches():
    params = pf.init_params(TINY_BASE, jax.random.PRNGKey(2))
    state = po.init_state(TINY, params)
    rng = np.random.default_rng(3)
    chunk = jnp.asarray((rng.standard_normal((1, 8000)) * 2000).astype(np.float32))
    state, fired, count, enc = po.encoder_step(params, TINY, state, chunk)
    state2, ids, count2 = po.decoder_step(params, TINY, state, enc, fired, jnp.asarray(3))
    assert ids.shape == (1, TINY.max_fires)
    assert int(state2["dec_valid"]) == min(TINY.chunk_positions, TINY.dec_cache_len)
    assert (np.asarray(ids)[0, 3:] == 0).all()  # masked beyond count


class _Tok:
    def decode(self, ids):
        return ",".join(map(str, ids))


def test_streaming_session_end_to_end():
    params = pf.init_params(TINY_BASE, jax.random.PRNGKey(4))
    sess = ParaformerStreamingSession(params, TINY, tokenizer=_Tok())
    rng = np.random.default_rng(5)
    audio = (rng.standard_normal(20000) * 2000).astype(np.float32)  # 1.25 s -> 3 chunks
    res = sess.transcribe(audio)
    assert res.audio_seconds == pytest.approx(1.25)
    assert isinstance(res.token_ids, list)
    assert res.rtf > 0
    # deterministic on re-run (state reset)
    res2 = sess.transcribe(audio)
    assert res2.token_ids == res.token_ids
