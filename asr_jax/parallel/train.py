"""Training: CTC fine-tuning step for SenseVoice-style encoders.

The reference toolkit has no training (SURVEY.md §0); this extends the
framework to fine-tuning so the multi-chip story (dp × tp over an ICI
mesh) is exercised end-to-end. Loss: CTC (optax), computed from the same
``encode_logits`` path inference uses, so padded-batch masking semantics
are shared.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import optax

from asr_jax.models import sensevoice as sv


def ctc_loss_from_logits(
    logits: jnp.ndarray,
    valid_seq: jnp.ndarray,
    labels: jnp.ndarray,
    label_valid: jnp.ndarray,
    blank_id: int = 0,
) -> jnp.ndarray:
    t = logits.shape[1]
    n = labels.shape[1]
    logit_paddings = (jnp.arange(t)[None, :] >= valid_seq[:, None]).astype(jnp.float32)
    label_paddings = (jnp.arange(n)[None, :] >= label_valid[:, None]).astype(jnp.float32)
    per_seq = optax.ctc_loss(logits, logit_paddings, labels, label_paddings, blank_id=blank_id)
    return jnp.mean(per_seq)


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01):
    return optax.adamw(lr, weight_decay=weight_decay)


@functools.partial(jax.jit, static_argnames=("cfg", "optimizer"))
def train_step(
    params: Any,
    opt_state: Any,
    cfg: sv.SenseVoiceConfig,
    optimizer,
    audio: jnp.ndarray,
    valid_samples: jnp.ndarray,
    language_idx: jnp.ndarray,
    labels: jnp.ndarray,
    label_valid: jnp.ndarray,
):
    """One dp×tp-shardable CTC training step. Shapes are fixed; sharding
    comes from the placement of ``params`` and the batch inputs."""

    def loss_fn(p):
        logits, valid_seq = sv.encode_logits(p, cfg, audio, valid_samples, language_idx)
        return ctc_loss_from_logits(
            logits.astype(jnp.float32), valid_seq, labels, label_valid, cfg.blank_id
        )

    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    return params, opt_state, loss


def aed_ce_loss(
    logits: jnp.ndarray,
    targets: jnp.ndarray,
    target_valid: jnp.ndarray,
    label_smoothing: float = 0.1,
) -> jnp.ndarray:
    """Masked teacher-forced cross-entropy with label smoothing for AED
    decoders. logits (B, S, V) at positions predicting ``targets`` (B, S)."""
    v = logits.shape[-1]
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None].astype(jnp.int32), axis=-1)[..., 0]
    if label_smoothing:
        uniform = -jnp.mean(logp, axis=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * uniform
    mask = (jnp.arange(targets.shape[1])[None, :] < target_valid[:, None]).astype(jnp.float32)
    return jnp.sum(nll * mask) / jnp.maximum(jnp.sum(mask), 1.0)


@functools.partial(jax.jit, static_argnames=("cfg", "optimizer", "label_smoothing"))
def whisper_train_step(
    params: Any,
    opt_state: Any,
    cfg,
    optimizer,
    mel: jnp.ndarray,
    tokens: jnp.ndarray,
    token_valid: jnp.ndarray,
    label_smoothing: float = 0.1,
):
    """Teacher-forced AED fine-tuning step for Whisper-style models (the
    training counterpart the reference lacks for its AR families).

    ``tokens`` (B, S): [prompt... text... eot] padded; the loss predicts
    ``tokens[:, 1:]`` from ``tokens[:, :-1]`` over ``token_valid - 1``
    positions. dp x tp shardable with ``mesh.whisper_param_specs``.
    """
    from asr_jax.models import whisper as wh

    def loss_fn(p):
        enc = wh.encode(p, cfg, mel)
        state = wh.make_state(p, cfg, enc)
        logits, _ = wh._decoder_pass(
            p, cfg, state, tokens[:, :-1], jnp.asarray(0, jnp.int32)
        )
        return aed_ce_loss(logits, tokens[:, 1:], token_valid - 1, label_smoothing)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    return params, opt_state, loss


def predictor_states(params: Any, labels: jnp.ndarray, blank_id: int) -> jnp.ndarray:
    """Teacher-forced transducer predictor: LSTM scan over [blank, labels]
    -> (B, U+1, joint_dim) projected decoder states (matches the state
    threading of ``models/parakeet.joint_step`` exactly, so training and
    greedy inference share predictor semantics)."""
    from asr_jax.layers.lstm import lstm_step_stack
    from asr_jax.layers.transformer import dense

    dec = params["decoder"]
    b = labels.shape[0]
    tokens = jnp.concatenate(
        [jnp.full((b, 1), blank_id, labels.dtype), labels], axis=1
    )  # (B, U+1)
    n_layers = len(dec["lstm"])
    hidden = dec["lstm"][0]["w_hh"].shape[0]
    h0 = jnp.zeros((n_layers, b, hidden), jnp.float32)
    c0 = jnp.zeros((n_layers, b, hidden), jnp.float32)

    def step(carry, tok):
        h, c = carry
        emb = dec["embed"][tok]
        y, h2, c2 = lstm_step_stack(emb, h, c, dec["lstm"])
        return (h2, c2), y

    _, ys = jax.lax.scan(step, (h0, c0), tokens.T)  # (U+1, B, H)
    return dense(ys.transpose(1, 0, 2), dec["proj"])  # (B, U+1, joint_dim)


def transducer_joint_logits(params: Any, enc: jnp.ndarray, dec_states: jnp.ndarray,
                            vocab_size: int) -> jnp.ndarray:
    """Full-lattice joint: relu(enc[:, :, None] + dec[:, None, :]) -> head
    token logits (B, T, U+1, V) (duration logits of TDT heads are dropped —
    plain RNN-T likelihood trains the token distribution)."""
    from asr_jax.layers.transformer import dense

    z = jax.nn.relu(enc[:, :, None, :] + dec_states[:, None, :, :])
    return dense(z, params["decoder"]["head"])[..., :vocab_size]


@functools.partial(jax.jit, static_argnames=("cfg", "optimizer"))
def transducer_train_step(
    params: Any,
    opt_state: Any,
    cfg,
    optimizer,
    audio: jnp.ndarray,
    valid_samples: jnp.ndarray,
    labels: jnp.ndarray,
    label_valid: jnp.ndarray,
):
    """One dp×tp-shardable RNN-T training step for the Parakeet family
    (FastConformer encoder + LSTM predictor + joint)."""
    from asr_jax.models import parakeet as pk
    from asr_jax.parallel.rnnt_loss import rnnt_loss_from_logits

    def loss_fn(p):
        enc, t_valid = pk.encode(p, cfg, audio, valid_samples)
        dec_states = predictor_states(p, labels, cfg.blank_id)
        logits = transducer_joint_logits(p, enc, dec_states, cfg.vocab_size)
        return rnnt_loss_from_logits(
            logits.astype(jnp.float32), labels, t_valid, label_valid, cfg.blank_id
        )

    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    return params, opt_state, loss


def fit(
    step_fn,
    params: Any,
    optimizer,
    data_iter,
    num_steps: int,
    ckpt_dir: str | None = None,
    ckpt_every: int = 100,
    log_every: int = 10,
    resume: bool = True,
    log_fn=print,
):
    """Minimal fine-tuning driver: ``step_fn(params, opt_state, optimizer,
    *batch) -> (params, opt_state, loss)`` over batches from ``data_iter``,
    with orbax checkpoint/resume (the reference toolkit has no training;
    this completes the framework's train story: ingest -> sharded step ->
    checkpoint -> resume).

    Returns (params, opt_state, losses). With ``resume=True`` and an
    existing ``ckpt_dir``, training continues from the latest step (batches
    already consumed are skipped by fast-forwarding the iterator).
    """
    from asr_jax.parallel import checkpoint as ckpt

    opt_state = optimizer.init(params)
    start = 0
    if resume and ckpt_dir is not None:
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            params, opt_state, start = ckpt.restore_train_state(
                ckpt_dir, {"params": params, "opt_state": opt_state,
                           "step": jnp.asarray(0)})
            log_fn(f"resumed from step {start}")

    losses = []
    it = iter(data_iter)
    for _ in range(start):  # deterministic iterators replay consumed batches
        next(it, None)
    for step in range(start, num_steps):
        batch = next(it, None)
        if batch is None:
            break
        params, opt_state, loss = step_fn(params, opt_state, optimizer, *batch)
        losses.append(float(loss))
        if log_every and (step + 1) % log_every == 0:
            log_fn(f"step {step + 1}/{num_steps} loss {losses[-1]:.4f}")
        if ckpt_dir is not None and ckpt_every and (step + 1) % ckpt_every == 0:
            ckpt.save_train_state(ckpt_dir, params, opt_state, step + 1)
    if ckpt_dir is not None:
        final = start + len(losses)
        if ckpt.latest_step(ckpt_dir) != final:
            ckpt.save_train_state(ckpt_dir, params, opt_state, final)
    return params, opt_state, losses
