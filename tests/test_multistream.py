"""Multi-stream batched streaming: N vmapped concurrent sessions must be
token-identical to N sequential single-stream sessions, and per-stream
reset must not disturb neighbors."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from asr_jax.models import paraformer as pf
from asr_jax.streaming import multistream as ms
from asr_jax.streaming import paraformer_online as po
from asr_jax.runtime.streaming_session import ParaformerStreamingSession

TINY_BASE = pf.ParaformerConfig(
    vocab_size=50, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
    num_encoders0=1, num_encoders=1, num_decoders=1, num_decoder_ffn=1,
    fsmn_kernel=5, predictor_kernel=3,
)
TINY = po.ParaformerStreamConfig(base=TINY_BASE, chunk_samples=8000)


def _audio(seed, chunks=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(chunks * TINY.chunk_samples) * 2000).astype(np.float32)


def test_paraformer_multistream_matches_sequential_sessions():
    params = pf.init_params(TINY_BASE, jax.random.PRNGKey(0))
    n, chunks = 3, 3
    audios = [_audio(seed, chunks) for seed in range(n)]

    # Sequential single-stream reference (host-gated decoder, reference
    # semantics) — collect per-chunk fired ids per stream.
    want = []
    for a in audios:
        sess = ParaformerStreamingSession(params, TINY)
        ids = []
        for c in range(chunks):
            ids.append(sess.push_chunk(a[c * TINY.chunk_samples:(c + 1) * TINY.chunk_samples]))
        want.append(ids)

    runner = ms.paraformer_multistream(params, TINY, n)
    for c in range(chunks):
        batch = np.stack([a[c * TINY.chunk_samples:(c + 1) * TINY.chunk_samples] for a in audios])
        out = runner.step(batch)
        counts = np.asarray(out["count"])
        ids = np.asarray(out["ids"])
        for s in range(n):
            got = [int(t) for t in ids[s, : counts[s]]]
            assert got == want[s][c], (s, c, got, want[s][c])


def test_multistream_reset_isolates_streams():
    params = pf.init_params(TINY_BASE, jax.random.PRNGKey(0))
    runner = ms.paraformer_multistream(params, TINY, 2)
    a0, a1 = _audio(10, 2), _audio(11, 2)
    chunk = TINY.chunk_samples
    runner.step(np.stack([a0[:chunk], a1[:chunk]]))
    # reset stream 0; stream 1 must continue exactly as an unreset session
    runner.reset(0)
    out = runner.step(np.stack([a0[:chunk], a1[chunk : 2 * chunk]]))

    sess = ParaformerStreamingSession(params, TINY)
    sess.push_chunk(a1[:chunk])
    want = sess.push_chunk(a1[chunk : 2 * chunk])
    got = [int(t) for t in np.asarray(out["ids"])[1, : int(out["count"][1])]]
    assert got == want

    # stream 0 after reset behaves like a FRESH session on its first chunk
    fresh = ParaformerStreamingSession(params, TINY)
    want0 = fresh.push_chunk(a0[:chunk])
    got0 = [int(t) for t in np.asarray(out["ids"])[0, : int(out["count"][0])]]
    assert got0 == want0


def test_zipformer_multistream_matches_sequential():
    from asr_jax.models import zipformer as zf

    cfg = zf.ZipformerConfig(
        vocab_size=40, downsampling_factor=(1, 2), num_encoder_layers=(1, 1),
        encoder_dim=(32, 48), query_head_dim=(8, 8), pos_head_dim=(4, 4),
        value_head_dim=(8, 8), num_heads=(2, 2), feedforward_dim=(48, 64),
        cnn_module_kernel=(7, 7),
    )
    params = zf.init_params(cfg, jax.random.PRNGKey(1))
    n = 2
    rng = np.random.default_rng(3)
    wins = [
        [(rng.standard_normal(cfg.window_samples) * 2000).astype(np.float32) for _ in range(2)]
        for _ in range(n)
    ]
    want = []
    for s in range(n):
        state = zf.init_state(cfg)
        per = []
        for w in wins[s]:
            state, enc = zf.encoder_step(params, cfg, state, jnp.asarray(w))
            state, ids, count = zf.greedy_chunk(params, cfg, state, enc)
            per.append([int(t) for t in np.asarray(ids)[: int(count)]])
        want.append(per)

    runner = ms.zipformer_multistream(params, cfg, n)
    for c in range(2):
        out = runner.step(np.stack([wins[s][c] for s in range(n)]))
        for s in range(n):
            got = [int(t) for t in np.asarray(out["ids"])[s, : int(out["count"][s])]]
            assert got == want[s][c], (s, c)


def test_dolphin_multistream_matches_sequential():
    from asr_jax.models import dolphin as dp
    from asr_jax.streaming import dolphin_stream as ds

    base = dp.DolphinConfig(
        vocab_size=60, d_model=32, enc_layers=2, enc_heads=4, enc_ffn=48,
        cgmlp_dim=64, csgu_kernel=5, fusion_kernel=3, dec_layers=2, dec_heads=4,
        dec_ffn=48, sos_id=50, eos_id=51, max_target_positions=24,
    )
    cfg = ds.DolphinStreamConfig(base=base, chunk_frames=8, max_frames=64)
    params = dp.init_params(base, jax.random.PRNGKey(2))
    n = 2
    rng = np.random.default_rng(5)
    wins = [
        [(rng.standard_normal(cfg.window_samples) * 2000).astype(np.float32) for _ in range(2)]
        for _ in range(n)
    ]
    want = []
    for s in range(n):
        state = ds.init_state(cfg)
        per = []
        for w in wins[s]:
            state, ctc_ids, _enc = ds.encoder_step(params, cfg, state, jnp.asarray(w))
            per.append(np.asarray(ctc_ids)[0].tolist())
        want.append(per)

    runner = ms.dolphin_multistream(params, cfg, n)
    for c in range(2):
        out = runner.step(np.stack([wins[s][c] for s in range(n)]))
        for s in range(n):
            assert np.asarray(out["ctc_ids"])[s].tolist() == want[s][c], (s, c)


def test_nemotron_multistream_matches_sequential():
    from asr_jax.models import nemotron as nm
    from asr_jax.streaming import nemotron_stream as ns

    from asr_jax.frontend.nemo_mel import NemoMelConfig

    base = nm.NemotronConfig(
        vocab_size=30, d_model=32, num_layers=2, num_heads=4, ffn_dim=48,
        conv_kernel=5, sub_channels=8, pred_hidden=16, joint_hidden=16,
        prompt_hidden=16, lstm_layers=1, num_prompts=4,
        left_context=8, right_context=3,
        mel=NemoMelConfig(n_mels=40),
    )
    cfg = ns.NemotronStreamConfig(base=base)
    params = nm.init_params(base, jax.random.PRNGKey(3))
    n = 2
    rng = np.random.default_rng(6)
    wins = [
        [(rng.standard_normal(cfg.window_samples) * 0.1).astype(np.float32) for _ in range(2)]
        for _ in range(n)
    ]
    pid = jnp.asarray([0], jnp.int32)
    want = []
    for s in range(n):
        state = ns.init_state(cfg)
        per = []
        for w in wins[s]:
            state, enc_proj = ns.encoder_step(params, cfg, state, jnp.asarray(w)[None], pid)
            state, ids, count = ns.rnnt_stream_step(params, cfg, state, enc_proj)
            per.append([int(t) for t in np.asarray(ids)[0, : int(count)]])
        want.append(per)

    runner = ms.nemotron_multistream(params, cfg, n, prompt_id=0)
    for c in range(2):
        out = runner.step(np.stack([wins[s][c] for s in range(n)]))
        for s in range(n):
            got = [int(t) for t in np.asarray(out["ids"])[s, : int(out["count"][s])]]
            assert got == want[s][c], (s, c)
