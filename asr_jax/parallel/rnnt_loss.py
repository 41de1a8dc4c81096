"""RNN-T (transducer) loss as a diagonal-wavefront lax.scan.

The reference has no training path (SURVEY.md §5: "no training
checkpoints"); this framework adds transducer training so the RNN-T /
TDT families (Parakeet, Nemotron, X-ASR) can be fine-tuned on device. The
forward-variable recursion

    alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                            alpha[t, u-1] + label[t, u-1])

is evaluated along anti-diagonals (t + u = const): every cell on a
diagonal depends only on the previous diagonal, so one ``lax.scan`` of
T+U steps updates whole (B, T, U+1) slabs with pure elementwise work —
no per-cell host loop, static shapes, batch-friendly. Gradients flow
through the scan via autodiff with ``jax.checkpoint`` on the step to keep
the saved-residual footprint at O(T+U) masks instead of per-op.

Loss = -log P(labels | enc) = -(alpha[T-1, U] + blank[T-1, U]) gathered at
each sample's (T_valid, U_valid).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

NEG_INF = -1e30


@functools.partial(jax.jit, static_argnames=())
def rnnt_loss(
    log_probs: jnp.ndarray,   # (B, T, U+1, V) joint log-softmax
    labels: jnp.ndarray,      # (B, U) int32
    t_valid: jnp.ndarray,     # (B,) frames per sample
    u_valid: jnp.ndarray,     # (B,) label counts per sample
    blank_id: int | jnp.ndarray = 0,
) -> jnp.ndarray:
    """Per-sample negative log-likelihood (B,)."""
    b, t_max, u1, _ = log_probs.shape
    u_max = u1 - 1

    blank_lp = log_probs[..., blank_id]                       # (B, T, U+1)
    # label_lp[b, t, u] = log_prob of emitting labels[b, u] at (t, u)
    label_lp = jnp.take_along_axis(
        log_probs[:, :, :u_max, :], labels[:, None, :, None], axis=3
    )[..., 0]                                                  # (B, T, U)

    # Mask emissions outside each sample's valid lattice so paths cannot
    # escape through padding.
    t_ids = jnp.arange(t_max)[None, :, None]
    u_ids = jnp.arange(u1)[None, None, :]
    blank_lp = jnp.where((t_ids < t_valid[:, None, None]) & (u_ids <= u_valid[:, None, None]),
                         blank_lp, NEG_INF)
    label_lp = jnp.where((t_ids < t_valid[:, None, None])
                         & (u_ids[:, :, :u_max] < u_valid[:, None, None]),
                         label_lp, NEG_INF)

    alpha0 = jnp.full((b, t_max, u1), NEG_INF)
    alpha0 = alpha0.at[:, 0, 0].set(0.0)

    diag_t = jnp.arange(t_max)[None, :, None]
    diag_u = jnp.arange(u1)[None, None, :]

    @jax.checkpoint
    def step(alpha, d):
        # from above: arrived by emitting blank at (t-1, u)
        from_t = jnp.pad(alpha[:, :-1, :] + blank_lp[:, :-1, :],
                         ((0, 0), (1, 0), (0, 0)), constant_values=NEG_INF)
        # from left: arrived by emitting label u-1 at (t, u-1)
        from_u = jnp.pad(alpha[:, :, :-1] + label_lp,
                         ((0, 0), (0, 0), (1, 0)), constant_values=NEG_INF)
        new = jnp.logaddexp(from_t, from_u)
        on_diag = (diag_t + diag_u) == d
        return jnp.where(on_diag, new, alpha), None

    alpha, _ = jax.lax.scan(step, alpha0, jnp.arange(1, t_max + u1))

    # Total log-prob: final blank emitted from (T_valid-1, U_valid).
    tv = jnp.clip(t_valid - 1, 0, t_max - 1)
    uv = jnp.clip(u_valid, 0, u_max)
    gather = lambda m: m[jnp.arange(b), tv, uv]
    ll = gather(alpha) + gather(blank_lp)
    return -ll


def rnnt_loss_from_logits(logits, labels, t_valid, u_valid, blank_id=0):
    """Convenience: joint LOGITS (B, T, U+1, V) -> mean loss (scalar)."""
    lp = jax.nn.log_softmax(logits, axis=-1)
    return jnp.mean(rnnt_loss(lp, labels, t_valid, u_valid, blank_id))


def tdt_loss(
    token_log_probs: jnp.ndarray,   # (B, T, U+1, V) token log-softmax
    dur_log_probs: jnp.ndarray,     # (B, T, U+1, D) duration log-softmax
    labels: jnp.ndarray,            # (B, U)
    t_valid: jnp.ndarray,
    u_valid: jnp.ndarray,
    durations: tuple = (0, 1, 2, 3, 4),
    blank_id: int | jnp.ndarray = 0,
) -> jnp.ndarray:
    """Token-and-Duration Transducer NLL (Parakeet-TDT's training law;
    greedy counterpart in ``decode/tdt.py``).

    Transitions from (t, u): emit ``labels[u]`` with duration d (advance to
    (t+d, u+1)), or emit blank with duration d >= 1 (advance to (t+d, u)).
    Every transition strictly increases t+u, so the same anti-diagonal
    wavefront as :func:`rnnt_loss` applies — one lax.scan of T+U steps,
    each combining |durations| shifted slabs.
    """
    b, t_max, u1, _ = token_log_probs.shape
    u_max = u1 - 1

    blank_lp = token_log_probs[..., blank_id]
    label_lp = jnp.take_along_axis(
        token_log_probs[:, :, :u_max, :], labels[:, None, :, None], axis=3
    )[..., 0]

    t_ids = jnp.arange(t_max)[None, :, None]
    u_ids = jnp.arange(u1)[None, None, :]
    in_t = t_ids < t_valid[:, None, None]
    blank_lp = jnp.where(in_t & (u_ids <= u_valid[:, None, None]), blank_lp, NEG_INF)
    label_lp = jnp.where(in_t & (u_ids[:, :, :u_max] < u_valid[:, None, None]),
                         label_lp, NEG_INF)

    alpha0 = jnp.full((b, t_max, u1), NEG_INF).at[:, 0, 0].set(0.0)
    diag_t = jnp.arange(t_max)[None, :, None]
    diag_u = jnp.arange(u1)[None, None, :]

    def shift_t(m, d):
        """m[:, t-d, :] with NEG_INF fill (source row t-d)."""
        if d == 0:
            return m
        return jnp.pad(m[:, :-d, :], ((0, 0), (d, 0), (0, 0)),
                       constant_values=NEG_INF)

    @jax.checkpoint
    def step(alpha, diag):
        total = jnp.full(alpha.shape, NEG_INF)
        for di, d in enumerate(durations):
            dlp = dur_log_probs[..., di]
            if d >= 1:
                # blank, duration d: (t-d, u) -> (t, u)
                total = jnp.logaddexp(
                    total, shift_t(alpha + blank_lp + dlp, d))
            # label, duration d: (t-d, u-1) -> (t, u)
            lbl = alpha[:, :, :-1] + label_lp + dlp[:, :, :u_max]
            lbl = jnp.pad(lbl, ((0, 0), (0, 0), (1, 0)), constant_values=NEG_INF)
            total = jnp.logaddexp(total, shift_t(lbl, d))
        on_diag = (diag_t + diag_u) == diag
        return jnp.where(on_diag, total, alpha), None

    alpha, _ = jax.lax.scan(step, alpha0, jnp.arange(1, t_max + u1))

    # Finish: blank from (T_valid-1, U_valid) with any duration that leaves
    # the valid frames (the reference decoder stops once t >= T).
    tv = jnp.clip(t_valid - 1, 0, t_max - 1)
    uv = jnp.clip(u_valid, 0, u_max)
    bidx = jnp.arange(b)
    final_dur = jax.nn.logsumexp(
        jnp.stack([dur_log_probs[bidx, tv, uv, di]
                   for di, d in enumerate(durations) if d >= 1], axis=0),
        axis=0,
    )
    ll = alpha[bidx, tv, uv] + blank_lp[bidx, tv, uv] + final_dur
    return -ll
