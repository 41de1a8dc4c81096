"""RNN-T loss: diagonal-wavefront scan vs a brute-force numpy lattice DP,
padded-batch invariance, gradient sanity."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from asr_jax.parallel.rnnt_loss import rnnt_loss, rnnt_loss_from_logits


def _ref_nll(lp, label, T, U, blank):
    """O(T*U) float64 forward DP, the textbook recursion."""
    alpha = np.full((T, U + 1), -np.inf)
    alpha[0, 0] = 0.0
    for t in range(T):
        for u in range(U + 1):
            if t == 0 and u == 0:
                continue
            cands = []
            if t > 0:
                cands.append(alpha[t - 1, u] + lp[t - 1, u, blank])
            if u > 0:
                cands.append(alpha[t, u - 1] + lp[t, u - 1, label[u - 1]])
            alpha[t, u] = np.logaddexp.reduce(cands)
    return -(alpha[T - 1, U] + lp[T - 1, U, blank])


def _rand_lp(rng, t, u1, v):
    logits = rng.standard_normal((t, u1, v)).astype(np.float64)
    return logits - np.log(np.exp(logits).sum(-1, keepdims=True))


def test_matches_bruteforce_dp():
    rng = np.random.default_rng(0)
    t, u, v, blank = 6, 4, 8, 0
    lp = _rand_lp(rng, t, u + 1, v)
    label = rng.integers(1, v, size=u)
    want = _ref_nll(lp, label, t, u, blank)
    got = rnnt_loss(
        jnp.asarray(lp, jnp.float32)[None], jnp.asarray(label, jnp.int32)[None],
        jnp.asarray([t]), jnp.asarray([u]), blank,
    )
    np.testing.assert_allclose(float(got[0]), want, rtol=1e-4)


def test_padded_batch_invariance():
    rng = np.random.default_rng(1)
    t_max, u_max, v, blank = 8, 5, 7, 0
    lens = [(8, 5), (5, 2), (3, 0)]
    lp = _rand_lp(rng, t_max, u_max + 1, v)
    lps, labels = [], []
    for _ in lens:
        lps.append(_rand_lp(rng, t_max, u_max + 1, v))
        labels.append(rng.integers(1, v, size=u_max))
    batch = rnnt_loss(
        jnp.asarray(np.stack(lps), jnp.float32),
        jnp.asarray(np.stack(labels), jnp.int32),
        jnp.asarray([t for t, _ in lens]), jnp.asarray([u for _, u in lens]), blank,
    )
    for i, (t, u) in enumerate(lens):
        want = _ref_nll(lps[i], labels[i], t, u, blank)
        np.testing.assert_allclose(float(batch[i]), want, rtol=1e-4,
                                   err_msg=f"sample {i} lens {(t, u)}")


def test_gradients_match_numeric():
    rng = np.random.default_rng(2)
    t, u, v = 4, 2, 5
    logits = rng.standard_normal((1, t, u + 1, v)).astype(np.float64) * 0.5
    label = rng.integers(1, v, size=(1, u))

    def loss_np(flat):
        lg = jnp.asarray(flat.reshape(logits.shape), jnp.float32)
        return float(rnnt_loss_from_logits(lg, jnp.asarray(label, jnp.int32),
                                           jnp.asarray([t]), jnp.asarray([u])))

    g = jax.grad(lambda lg: rnnt_loss_from_logits(
        lg, jnp.asarray(label, jnp.int32), jnp.asarray([t]), jnp.asarray([u])))(
        jnp.asarray(logits, jnp.float32))
    g = np.asarray(g).ravel()
    flat = logits.ravel().copy()
    eps = 1e-3
    idxs = rng.choice(flat.size, 6, replace=False)
    for i in idxs:
        fp = flat.copy(); fp[i] += eps
        fm = flat.copy(); fm[i] -= eps
        num = (loss_np(fp) - loss_np(fm)) / (2 * eps)
        np.testing.assert_allclose(g[i], num, rtol=0.05, atol=2e-3,
                                   err_msg=f"coord {i}")


def test_perfect_model_low_loss():
    """A joint that puts ~all mass on the correct next symbol along the
    staircase path drives the loss toward 0."""
    t, u, v, blank = 5, 3, 6, 0
    label = np.array([2, 3, 4])
    logits = np.full((t, u + 1, v), -15.0, np.float32)
    # emit every label at frame 0, then blanks down the last column
    for uu in range(u):
        logits[0, uu, label[uu]] = 15.0
    for frame in range(t):
        logits[frame, u, blank] = 15.0
    loss = rnnt_loss_from_logits(
        jnp.asarray(logits)[None], jnp.asarray(label, jnp.int32)[None],
        jnp.asarray([t]), jnp.asarray([u]))
    assert float(loss) < 0.1


def test_transducer_train_step_decreases_loss():
    """Parakeet RNN-T fine-tuning: repeated steps on one batch reduce loss,
    and the step shards over a dp mesh (8 virtual CPU devices)."""
    from asr_jax.frontend.nemo_mel import NemoMelConfig
    from asr_jax.models import parakeet as pk
    from asr_jax.parallel import train

    cfg = pk.ParakeetConfig(
        vocab_size=24, blank_id=23, d_model=32, num_layers=1, num_heads=4,
        ffn_dim=48, sub_channels=8, dec_hidden=16, lstm_layers=1,
        mel=NemoMelConfig(n_mels=40),
    )
    params = pk.init_params(cfg, jax.random.PRNGKey(0))
    optimizer = train.make_optimizer(lr=3e-3)
    opt_state = optimizer.init(params)

    rng = np.random.default_rng(0)
    audio = jnp.asarray((rng.standard_normal((2, 8000)) * 0.1).astype(np.float32))
    valid = jnp.asarray([8000, 6000])
    labels = jnp.asarray(rng.integers(0, 23, size=(2, 5)), jnp.int32)
    label_valid = jnp.asarray([5, 3])

    losses = []
    for _ in range(6):
        params, opt_state, loss = train.transducer_train_step(
            params, opt_state, cfg, optimizer, audio, valid, labels, label_valid)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses

    # dp-sharded execution on the virtual mesh
    from asr_jax.parallel.mesh import batch_sharded, make_mesh, replicated

    mesh = make_mesh(model_parallel=1)
    p_sh = jax.device_put(params, replicated(mesh))
    o_sh = jax.device_put(opt_state, replicated(mesh))
    bs = batch_sharded(mesh)
    n = mesh.shape["data"]
    big = lambda x: jnp.tile(x, (n // 2 if n >= 2 else 1,) + (1,) * (x.ndim - 1))
    _, _, loss_sh = train.transducer_train_step(
        p_sh, o_sh, cfg, optimizer,
        jax.device_put(big(audio), bs), jax.device_put(big(valid), bs),
        jax.device_put(big(labels), bs), jax.device_put(big(label_valid), bs))
    assert np.isfinite(float(loss_sh))


def _ref_tdt_nll(tok_lp, dur_lp, label, T, U, durations, blank):
    """float64 brute-force TDT lattice DP with the same boundary
    convention: paths land on cells, final blank (d>=1) exits at (T-1, U)."""
    alpha = np.full((T, U + 1), -np.inf)
    alpha[0, 0] = 0.0
    for s in range(1, T + U + 1):
        for t in range(T):
            u = s - t
            if not (0 <= u <= U):
                continue
            cands = []
            for di, d in enumerate(durations):
                ts = t - d
                if ts >= 0 and d >= 1:  # blank
                    cands.append(alpha[ts, u] + tok_lp[ts, u, blank] + dur_lp[ts, u, di])
                if ts >= 0 and u >= 1:  # label
                    cands.append(alpha[ts, u - 1] + tok_lp[ts, u - 1, label[u - 1]]
                                 + dur_lp[ts, u - 1, di])
            if cands:
                alpha[t, u] = np.logaddexp.reduce(cands)
    final = np.logaddexp.reduce([dur_lp[T - 1, U, di]
                                 for di, d in enumerate(durations) if d >= 1])
    return -(alpha[T - 1, U] + tok_lp[T - 1, U, blank] + final)


def test_tdt_loss_matches_bruteforce():
    from asr_jax.parallel.rnnt_loss import tdt_loss

    rng = np.random.default_rng(5)
    t, u, v, durations, blank = 7, 3, 6, (0, 1, 2), 0
    tok = _rand_lp(rng, t, u + 1, v)
    dur = _rand_lp(rng, t, u + 1, len(durations))
    label = rng.integers(1, v, size=u)
    want = _ref_tdt_nll(tok, dur, label, t, u, durations, blank)
    got = tdt_loss(
        jnp.asarray(tok, jnp.float32)[None], jnp.asarray(dur, jnp.float32)[None],
        jnp.asarray(label, jnp.int32)[None], jnp.asarray([t]), jnp.asarray([u]),
        durations=durations, blank_id=blank,
    )
    np.testing.assert_allclose(float(got[0]), want, rtol=1e-4)

    # padded invariance: same sample inside a bigger buffer
    tok_pad = np.full((t + 3, u + 3, v), -7.0)
    dur_pad = np.full((t + 3, u + 3, len(durations)), -3.0)
    tok_pad[:t, : u + 1] = tok
    dur_pad[:t, : u + 1] = dur
    label_pad = np.zeros(u + 2, np.int64)
    label_pad[:u] = label
    got2 = tdt_loss(
        jnp.asarray(tok_pad, jnp.float32)[None], jnp.asarray(dur_pad, jnp.float32)[None],
        jnp.asarray(label_pad, jnp.int32)[None], jnp.asarray([t]), jnp.asarray([u]),
        durations=durations, blank_id=blank,
    )
    np.testing.assert_allclose(float(got2[0]), want, rtol=1e-4)
