"""Nemotron streaming: streamed encoder frames must match the offline
chunked-mask encoder frame-for-frame (the reference's design contract),
and the RNN-T continuation must match a single offline decode."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from asr_jax.frontend.nemo_mel import NemoMelConfig
from asr_jax.models import nemotron as nm
from asr_jax.streaming import nemotron_stream as ns

BASE = nm.NemotronConfig(
    vocab_size=30, d_model=32, num_layers=2, num_heads=4, ffn_dim=48,
    conv_kernel=5, sub_channels=8, pred_hidden=16, joint_hidden=16,
    prompt_hidden=16, lstm_layers=1, num_prompts=4,
    left_context=8, right_context=3,  # chunk = 4 encoder frames
    mel=NemoMelConfig(n_mels=40),
)
CFG = ns.NemotronStreamConfig(base=BASE)


def test_streamed_encoder_matches_offline_chunked():
    params = nm.init_params(BASE, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    n_chunks = 4
    mel_frames = CFG.mel_chunk * n_chunks  # 32 * 4
    mel = rng.standard_normal((1, mel_frames, BASE.mel.n_mels)).astype(np.float32)

    # Offline: full-sequence encode with the chunked block mask.
    off, off_valid = nm.encode_features(
        params, BASE, jnp.asarray(mel), jnp.asarray([mel_frames]), jnp.asarray([0])
    )
    off = np.asarray(off)[0]

    # Streaming: chunk-by-chunk with carried caches.
    state = ns.init_state(CFG)
    streamed = []
    for c in range(n_chunks):
        chunk_mel = jnp.asarray(mel[:, c * CFG.mel_chunk : (c + 1) * CFG.mel_chunk])
        state, enc = ns.encoder_step_features(params, CFG, state, chunk_mel, jnp.asarray([0]))
        streamed.append(np.asarray(enc)[0])
    streamed = np.concatenate(streamed, axis=0)

    n = min(len(streamed), int(off_valid[0]))
    np.testing.assert_allclose(streamed[:n], off[:n], rtol=2e-3, atol=2e-4)


def test_rnnt_stream_continuation_matches_offline_decode():
    from asr_jax.decode.rnnt import rnnt_greedy
    from asr_jax.models.nemotron import joint_step

    params = nm.init_params(BASE, jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    enc = jnp.asarray(rng.standard_normal((1, 12, BASE.joint_hidden)).astype(np.float32))

    # Offline greedy over all 12 frames.
    h0 = jnp.zeros((BASE.lstm_layers, 1, BASE.pred_hidden))
    toks_ref, n_ref = rnnt_greedy(
        lambda t, h, c, e: joint_step(params, t, h, c, e), enc, jnp.asarray([12]),
        h0, h0, start_token=BASE.blank_id, blank_id=BASE.blank_id,
        max_tokens=200, max_symbols_per_frame=BASE.max_symbols_per_frame,
    )
    ref = np.asarray(toks_ref)[0, : int(n_ref[0])].tolist()

    # Streaming: 3 chunks of 4 frames with carried predictor state.
    state = ns.init_state(CFG)
    state = {**state, "token": jnp.asarray([BASE.blank_id], jnp.int32)}
    out = []
    for c in range(3):
        state, ids, count = ns.rnnt_stream_step(
            params, CFG, state, enc[:, c * 4 : (c + 1) * 4], max_new=64
        )
        out.extend(int(t) for t in np.asarray(ids)[0, : int(count)])
    assert out == ref


def test_stream_mel_window_geometry():
    rng = np.random.default_rng(2)
    audio = jnp.asarray((rng.standard_normal((1, CFG.window_samples)) * 0.1).astype(np.float32))
    mel = ns._stream_mel(CFG, audio)
    assert mel.shape == (1, CFG.mel_chunk, BASE.mel.n_mels)


def test_rel_k_cache_identical_to_in_graph():
    """precompute_rel_k hoists a params-only constant out of the chunk
    step: the cached path must be BITWISE identical to the in-graph
    projection."""
    params = nm.init_params(BASE, jax.random.PRNGKey(0))
    relk = ns.precompute_rel_k(params, CFG)
    hd = BASE.d_model // BASE.num_heads
    assert relk.shape == (BASE.num_layers, 2 * CFG.kv_len - 1,
                          BASE.num_heads, hd)
    rng = np.random.default_rng(5)
    pid = jnp.zeros((1,), jnp.int32)
    s_a = ns.init_state(CFG)
    s_b = ns.init_state(CFG)
    for _ in range(3):
        win = jnp.asarray((rng.standard_normal(CFG.window_samples) * 0.1)
                          .astype(np.float32))[None]
        s_a, enc_a = ns.encoder_step(params, CFG, s_a, win, pid)
        s_b, enc_b = ns.encoder_step(params, CFG, s_b, win, pid, relk)
        np.testing.assert_array_equal(np.asarray(enc_a), np.asarray(enc_b))
    for la, lb in zip(jax.tree.leaves(s_a), jax.tree.leaves(s_b)):
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
