"""Dolphin streaming: chunk step shapes/caches, subsampling alignment of
chunked windows vs one continuous pass, CTC stream collapse, rescoring."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from asr_jax.decode.ar import DecodeConfig
from asr_jax.models import dolphin as dp
from asr_jax.streaming import dolphin_stream as ds

BASE = dp.DolphinConfig(
    vocab_size=60, d_model=32, enc_layers=2, enc_heads=4, enc_ffn=48,
    cgmlp_dim=64, csgu_kernel=5, fusion_kernel=3, dec_layers=2, dec_heads=4,
    dec_ffn=48, sos_id=50, eos_id=51, max_target_positions=24,
)
CFG = ds.DolphinStreamConfig(base=BASE, chunk_frames=8, max_frames=64)


def test_window_geometry():
    assert CFG.mel_per_chunk == 32
    assert CFG.window_mel == 35
    assert CFG.advance_samples == 32 * 160
    assert CFG.window_samples == 34 * 160 + 400


def _windows(audio):
    w, a = CFG.window_samples, CFG.advance_samples
    n_chunks = (len(audio) - (w - a)) // a
    return [audio[c * a : c * a + w] for c in range(n_chunks)]


def test_chunk_step_shapes_and_valid():
    params = dp.init_params(BASE, jax.random.PRNGKey(0))
    state = ds.init_state(CFG)
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(CFG.advance_samples * 3 + CFG.window_samples) * 2000).astype(np.float32)
    for c, win in enumerate(_windows(audio)):
        state, ctc_ids, enc = ds.encoder_step(params, CFG, state, jnp.asarray(win))
        assert enc.shape == (1, CFG.chunk_frames, BASE.d_model)
        assert ctc_ids.shape == (1, CFG.chunk_frames)
        assert int(state["valid"]) == (c + 1) * CFG.chunk_frames


def test_subsampling_alignment_across_chunks():
    """Encoder-rate frames from chunked windows must equal frames from one
    continuous pass of the same subsampling conv."""
    params = dp.init_params(BASE, jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal(CFG.advance_samples * 3 + CFG.window_samples) * 2000).astype(np.float32)

    from asr_jax.frontend.kaldi_fbank import log_mel_fbank
    from asr_jax.layers.transformer import dense

    def subsample(mel):
        x = mel[..., None]
        sub = params["subsample"]
        for key in ("conv0", "conv1"):
            x = jax.nn.relu(jax.lax.conv_general_dilated(
                x, sub[key]["w"], (2, 2), [(0, 0), (0, 0)],
                dimension_numbers=("NHWC", "HWIO", "NHWC")) + sub[key]["b"])
        t = x.shape[1]
        return np.asarray(dense(x.transpose(0, 1, 3, 2).reshape(1, t, -1), sub["out"]) * (BASE.d_model ** 0.5))[0]

    n_frames = (len(audio) - 400) // 160 + 1
    mel = log_mel_fbank(jnp.asarray(audio)[None], CFG.fbank, n_frames)
    mel = (mel - params["cmvn_mean"]) * params["cmvn_istd"]
    cont = subsample(mel)

    outs = []
    for win in _windows(audio):
        melw = log_mel_fbank(jnp.asarray(win)[None], CFG.fbank, CFG.window_mel)
        melw = (melw - params["cmvn_mean"]) * params["cmvn_istd"]
        outs.append(subsample(melw)[: CFG.chunk_frames])
    chunked = np.concatenate(outs, 0)
    n = min(len(chunked), len(cont))
    np.testing.assert_allclose(chunked[:n], cont[:n], rtol=1e-4, atol=1e-5)


def test_stream_ctc_collapse():
    ids = [[0, 5, 5, 0], [5, 7, 0, 0], [7, 7, 9, 0]]
    # chunk-boundary repeats collapse too (prev carried across chunks)
    assert ds.collapse_stream_ctc(ids, blank_id=0) == [5, 5, 7, 7, 9]


def test_rescore_decode_runs():
    params = dp.init_params(BASE, jax.random.PRNGKey(2))
    state = ds.init_state(CFG)
    rng = np.random.default_rng(2)
    audio = (rng.standard_normal(CFG.advance_samples * 2 + CFG.window_samples) * 2000).astype(np.float32)
    for win in _windows(audio):
        state, ctc_ids, enc = ds.encoder_step(params, CFG, state, jnp.asarray(win))
    prompt = jnp.asarray([[BASE.sos_id]], jnp.int32)
    dc = DecodeConfig(max_new_tokens=6, eot_id=BASE.eos_id, strategy="greedy")
    tokens, counts = ds.rescore_decode(params, CFG, state, prompt, dc)
    assert tokens.shape[0] == 1 and int(counts[0]) >= 1


def test_streaming_session_named_language_forcing():
    """DolphinStreamingSession resolves --language names through the same
    catalog as the offline session (forced prompt ids for the final AR
    rescoring pass); unmapped names raise."""
    import pytest

    from asr_jax.runtime.streaming_session import DolphinStreamingSession

    cat = {"languages": {"zh": 41, "ja": 42}, "regions": {"CN": 44},
           "asr_id": 40, "notimestamp_id": 47, "aliases": {"Japanese": "ja"}}
    params = dp.init_params(BASE, jax.random.PRNGKey(0))
    sess = DolphinStreamingSession(params, CFG, language_catalog=cat,
                                   language="Japanese")
    assert (sess.language_id, sess.region_id) == (42, -2)
    sess = DolphinStreamingSession(params, CFG, language_catalog=cat,
                                   language="zh-CN")
    assert (sess.language_id, sess.region_id) == (41, 44)
    with pytest.raises(KeyError):
        DolphinStreamingSession(params, CFG, language_catalog=cat,
                                language="Klingon")


def test_rel_k_cache_identical_to_in_graph():
    """precompute_rel_k hoists a params-only constant out of the chunk
    step: the cached path must be BITWISE identical to the in-graph
    projection (same dense on the same values, just computed once)."""
    params = dp.init_params(BASE, jax.random.PRNGKey(0))
    relk = ds.precompute_rel_k(params, CFG)
    assert relk.shape == (BASE.enc_layers, CFG.max_frames, BASE.enc_heads,
                          BASE.head_dim)
    rng = np.random.default_rng(7)
    audio = (rng.standard_normal(CFG.advance_samples * 2 + CFG.window_samples)
             * 2000).astype(np.float32)
    s_a, s_b = ds.init_state(CFG), ds.init_state(CFG)
    for win in _windows(audio):
        w = jnp.asarray(win)
        s_a, ids_a, enc_a = ds.encoder_step(params, CFG, s_a, w)
        s_b, ids_b, enc_b = ds.encoder_step(params, CFG, s_b, w, relk)
        np.testing.assert_array_equal(np.asarray(ids_a), np.asarray(ids_b))
        np.testing.assert_array_equal(np.asarray(enc_a), np.asarray(enc_b))
    for la, lb in zip(jax.tree.leaves(s_a), jax.tree.leaves(s_b)):
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))


def test_append_rows_scatter_free_matches_dus_including_clamp():
    """The one-hot/select scatter-free write (vmapped multistream path)
    must equal per-stream dynamic_update_slice for mixed offsets INCLUDING
    the dus clamp edge (start > T - n), hit after history saturates."""
    import functools
    import jax
    import jax.numpy as jnp
    import numpy as np
    from asr_jax.streaming.dolphin_stream import _append_rows

    L, T, H, D, n, B = 3, 12, 2, 4, 5, 4
    rng = np.random.default_rng(0)
    buf = jnp.asarray(rng.standard_normal((B, L, T, H, D)).astype(np.float32))
    new = jnp.asarray(rng.standard_normal((B, n, H, D)).astype(np.float32))
    starts = jnp.asarray([0, 3, T - n, T])  # T clamps to T - n
    for li in range(L):
        fn = functools.partial(_append_rows, li=li, scatter_free=True)
        got = jax.vmap(lambda b, v, s: fn(b, v, start=s))(buf, new, starts)
        want = jnp.stack([
            _append_rows(buf[i], new[i], li, int(starts[i]), scatter_free=False)
            for i in range(B)])
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=0)
