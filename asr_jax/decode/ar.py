"""Generic autoregressive decode loop: one jitted ``lax.while_loop``.

The reference drives AR decoding from Python — one ONNX session launch per
token with OrtValue ping-pong (``Whisper/Inference_Whisper_ONNX.py:584-663``)
and reads one scalar back per step. Here the entire loop lives on device:
KV caches, token history, penalty window, sampling PRNG and the stop test
are all ``while_loop`` carry state; the host gets the final buffer once
(SURVEY.md §3.5 "the rebuild's central win").

Works for any model exposing ``step(state, tokens, pos) -> (logits, state)``
with fixed-shape ``state`` (Whisper, FireRedASR, Dolphin, Fun-ASR-Nano,
Qwen3-ASR decoders).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp

from asr_jax.decode.strategies import (
    apply_repetition_penalty,
    suppress_tokens,
    top_k_top_p_sample,
)


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    max_new_tokens: int
    eot_id: int
    suppress_ids: tuple[int, ...] = ()
    strategy: str = "greedy"  # greedy | penalty | sampling
    penalty: float = 1.0
    penalty_range: int = 64
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0


def select_token(
    logits: jnp.ndarray,
    history_buf: jnp.ndarray,
    history_len: jnp.ndarray,
    cfg: DecodeConfig,
    key: jax.Array,
    history_start: jnp.ndarray | int = 0,
) -> tuple[jnp.ndarray, jax.Array]:
    """Pick the next token from already-suppressed logits ``(B, V)`` using the
    configured strategy. Shared by the in-loop steps AND the prefill first
    token so both are decoded consistently (the reference routes prefill
    logits through the same strategy graph,
    ``Whisper/Inference_Whisper_ONNX.py:584-612``).

    ``history_buf (B, T)`` / ``history_len`` feed the repetition penalty;
    ``history_start`` (the prompt length) excludes prompt slots — the
    reference penalizes only generated ids (``save_id`` starts empty).
    Returns ``(token (B,), next key)``.
    """
    if cfg.strategy in ("penalty", "sampling") and cfg.penalty != 1.0:
        logits = apply_repetition_penalty(
            logits, history_buf, history_len, cfg.penalty, cfg.penalty_range,
            hist_start=history_start,
        )
    if cfg.strategy == "sampling":
        key, sub = jax.random.split(key)
        return top_k_top_p_sample(logits, sub, cfg.temperature, cfg.top_k, cfg.top_p), key
    return jnp.argmax(logits, axis=-1).astype(jnp.int32), key


def ar_decode(
    step: Callable[[Any, jnp.ndarray, jnp.ndarray], tuple[jnp.ndarray, Any]],
    state: Any,
    prompt_len: jnp.ndarray,
    first_token: jnp.ndarray,
    token_buffer: jnp.ndarray,
    cfg: DecodeConfig,
    rng: jax.Array | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Run the AR loop.

    Args:
      step: ``(state, tokens (B,1), pos scalar) -> (logits (B,V), state)`` —
        feeds ONE token through the decoder at position ``pos`` (KV caches
        inside ``state`` must already hold the prompt prefill).
      state: fixed-shape carry (KV caches etc.).
      prompt_len: scalar int32 — prompt length (same for the batch; pad
        prompts to equal length).
      first_token: ``(B,)`` first generated token (from the prefill logits).
      token_buffer: ``(B, T_total)`` int32 buffer holding the prompt;
        generated ids are written from ``prompt_len`` onward.
      cfg: decode configuration.
      rng: PRNG key (sampling strategy only).

    Returns:
      (tokens ``(B, T_total)``, num_generated ``(B,)``) — num includes the
      EOT token when produced.
    """
    b, t_total = token_buffer.shape
    if rng is None:
        rng = jax.random.PRNGKey(0)

    token_buffer = jax.lax.dynamic_update_slice(
        token_buffer, first_token[:, None].astype(token_buffer.dtype), (0, prompt_len)
    )
    finished0 = first_token == cfg.eot_id
    counts0 = jnp.ones((b,), jnp.int32)

    def cond(carry):
        i, _state, _buf, _counts, finished, _key = carry
        return (i < cfg.max_new_tokens) & ~jnp.all(finished)

    def body(carry):
        i, state, buf, counts, finished, key = carry
        pos = prompt_len + i
        cur = jax.lax.dynamic_slice(buf, (0, pos), (b, 1)).astype(jnp.int32)
        logits, state = step(state, cur, pos)
        logits = suppress_tokens(logits.astype(jnp.float32), cfg.suppress_ids)
        nxt, key = select_token(logits, buf, pos + 1, cfg, key, history_start=prompt_len)
        nxt = jnp.where(finished, cfg.eot_id, nxt)
        buf = jax.lax.dynamic_update_slice(buf, nxt[:, None].astype(buf.dtype), (0, pos + 1))
        counts = counts + jnp.where(finished, 0, 1).astype(jnp.int32)
        finished = finished | (nxt == cfg.eot_id)
        return (i + 1, state, buf, counts, finished, key)

    init = (jnp.asarray(0, jnp.int32), state, token_buffer, counts0, finished0, rng)
    _, _, buf, counts, _, _ = jax.lax.while_loop(cond, body, init)
    return buf, counts
