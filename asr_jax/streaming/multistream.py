"""Multi-stream batched streaming: N concurrent real-time sessions, ONE
vmapped jitted device step per chunk tick.

The reference runtime is strictly single-stream (one ORT session per
process, caches ping-ponged per stream —
``Paraformer/Streaming/Inference_Paraformer_Streaming_ONNX.py:405-449``).
The per-chunk step is a pure function of (params, state, chunk), so
serving N streams is ``jax.vmap`` over stacked state pytrees: one device
dispatch per tick carries every stream, and per-stream chunk latency stays
~flat while throughput scales with N (chunk compute is far from saturating
the chip at batch 1).

Decoder gating: the single-stream session host-reads the CIF fire count
and skips the decoder when 0 (reference behavior, caches untouched).
Streams fire independently, so here the gate is a ``lax.cond`` INSIDE the
step — under vmap it lowers to select (both branches run batched), which
preserves the cache semantics exactly while keeping one fixed-shape
dispatch.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np


class MultiStreamRunner:
    """Run N independent copies of a streaming step as one device batch.

    ``init_state_fn() -> state`` builds ONE stream's state pytree;
    ``step_fn(params, state, chunk) -> (state', outputs)`` advances one
    stream by one chunk (pure, fixed shapes). All streams share ``params``.
    """

    def __init__(self, params, n_streams: int, init_state_fn: Callable[[], Any],
                 step_fn: Callable[..., Any]):
        self.params = params
        self.n_streams = int(n_streams)
        self._init_state_fn = init_state_fn
        one = init_state_fn()
        self.states = jax.tree.map(
            lambda x: jnp.broadcast_to(x[None], (self.n_streams,) + x.shape), one
        )
        self._step = jax.jit(jax.vmap(step_fn, in_axes=(None, 0, 0)))

        vstep = jax.vmap(step_fn, in_axes=(None, 0, 0))

        def masked(params, states, chunks, active):
            new_states, outs = vstep(params, states, chunks)
            sel = lambda n, o: jnp.where(
                active.reshape((-1,) + (1,) * (n.ndim - 1)), n, o)
            return jax.tree.map(sel, new_states, states), outs

        self._step_masked = jax.jit(masked)

        @jax.jit
        def masked_n(params, states, chunks_k, active_k):
            """K masked ticks in ONE dispatch (lax.scan over the tick body):
            the host pays one sync per K chunks instead of per chunk — the
            host<->device round trip amortizes exactly like the
            continuous engine's steps_per_tick. Outputs stack with a
            leading K axis; per-stream state evolution is IDENTICAL to K
            sequential masked steps."""
            def body(states, xs):
                chunks, active = xs
                return masked(params, states, chunks, active)

            return jax.lax.scan(body, states, (chunks_k, active_k))

        self._step_masked_n = masked_n

    def step(self, chunks: np.ndarray, active: np.ndarray | None = None):
        """chunks (n_streams, chunk_samples) -> outputs pytree, each leaf
        with a leading ``n_streams`` axis. One jitted dispatch.

        ``active``: optional (n_streams,) bool — slots marked False run in
        the batch (fixed shape) but their STATE is left untouched, so a
        connection without fresh audio this tick does not advance its
        caches; its outputs for the tick are garbage and must be dropped
        by the caller."""
        chunks = jnp.asarray(chunks)
        assert chunks.shape[0] == self.n_streams, (chunks.shape, self.n_streams)
        if active is None:
            self.states, outs = self._step(self.params, self.states, chunks)
            return outs
        self.states, outs = self._step_masked(
            self.params, self.states, chunks, jnp.asarray(active, bool))
        return outs

    def step_n(self, chunks: np.ndarray, active: np.ndarray):
        """K fused ticks: ``chunks (K, n_streams, chunk_samples)``,
        ``active (K, n_streams)`` -> outputs pytree with leading (K,
        n_streams) axes. ONE jitted dispatch + one host sync for all K
        ticks; an all-False subtick row is a no-op (state untouched), so
        callers pad short bursts to a fixed K and keep one executable."""
        chunks = jnp.asarray(chunks)
        assert chunks.ndim == 3 and chunks.shape[1] == self.n_streams
        self.states, outs = self._step_masked_n(
            self.params, self.states, chunks, jnp.asarray(active, bool))
        return outs

    def reset(self, stream: int) -> None:
        """Reset one stream's state (new utterance) without touching others."""
        fresh = self._init_state_fn()
        self.states = jax.tree.map(
            lambda s, f: s.at[stream].set(f.astype(s.dtype)), self.states, fresh
        )


def paraformer_multistream(params, cfg, n_streams: int) -> MultiStreamRunner:
    """N concurrent streaming-Paraformer sessions (0.5 s chunks).

    Step outputs: {"ids": (N, max_fires) int32, "count": (N,) int32} —
    tokens fired by each stream this chunk (count 0 = nothing fired; the
    decoder caches of such streams are left untouched via lax.cond).
    """
    from asr_jax.streaming import paraformer_online as po

    def step(p, state, chunk):
        state, fired, count, enc_out = po.encoder_step(p, cfg, state, chunk[None])

        def run_dec(st):
            st, ids, n = po.decoder_step(p, cfg, st, enc_out, fired, count)
            return st, ids[0], n

        def skip_dec(st):
            return st, jnp.zeros((fired.shape[1],), jnp.int32), jnp.asarray(0, jnp.int32)

        state, ids, n = jax.lax.cond(count > 0, run_dec, skip_dec, state)
        return state, {"ids": ids, "count": n}

    return MultiStreamRunner(params, n_streams, lambda: po.init_state(cfg, params), step)


def zipformer_multistream(params, cfg, n_streams: int) -> MultiStreamRunner:
    """N concurrent X-ASR Zipformer2 transducer streams (one window/tick).

    Step outputs: {"ids": (N, max_new), "count": (N,)}."""
    from asr_jax.models import zipformer as zf

    def step(p, state, window):
        state, enc = zf.encoder_step(p, cfg, state, window)
        state, ids, count = zf.greedy_chunk(p, cfg, state, enc)
        return state, {"ids": ids, "count": count}

    return MultiStreamRunner(params, n_streams, lambda: zf.init_state(cfg), step)


def dolphin_multistream(params, cfg, n_streams: int) -> MultiStreamRunner:
    """N concurrent Dolphin CN-Dialect streaming encoders (per-chunk CTC).

    Step outputs: {"ctc_ids": (N, chunk_frames) int32} — raw per-chunk CTC
    ids (collapse across chunks with ``dolphin_stream.collapse_stream_ctc``
    per stream, as the single-stream session does)."""
    from asr_jax.streaming import dolphin_stream as ds

    # The projected position-key table is a params-only constant; ride it
    # inside the (broadcast) params pytree so it is computed once, not per
    # stream per tick (it dominated the per-chunk FLOPs before hoisting).
    params = dict(params, _rel_k_cache=ds.precompute_rel_k(params, cfg))

    def step(p, state, window):
        relk = p["_rel_k_cache"]
        model_p = {k: v for k, v in p.items() if k != "_rel_k_cache"}
        # scatter_free_writes: under vmap the per-stream `valid` offset
        # would lower the KV appends to scatters (6.1 of 7.96 ms/tick).
        state, ctc_ids, _enc = ds.encoder_step(model_p, cfg, state, window,
                                               relk, scatter_free_writes=True)
        return state, {"ctc_ids": ctc_ids[0]}

    return MultiStreamRunner(params, n_streams, lambda: ds.init_state(cfg), step)


def nemotron_multistream(params, cfg, n_streams: int,
                         prompt_id: int = 0) -> MultiStreamRunner:
    """N concurrent cache-aware Nemotron RNN-T streams.

    Step outputs: {"ids": (N, max_new), "count": (N,)}."""
    from asr_jax.streaming import nemotron_stream as ns

    pid = jnp.asarray([prompt_id], jnp.int32)
    # Params-only constant: projected position keys, computed once and
    # broadcast across streams inside the params pytree (not per tick).
    params = dict(params, _rel_k_cache=ns.precompute_rel_k(params, cfg))

    def step(p, state, window):
        relk = p["_rel_k_cache"]
        model_p = {k: v for k, v in p.items() if k != "_rel_k_cache"}
        state, enc_proj = ns.encoder_step(model_p, cfg, state, window[None], pid, relk)
        state, ids, count = ns.rnnt_stream_step(model_p, cfg, state, enc_proj)
        return state, {"ids": ids[0], "count": count}

    return MultiStreamRunner(params, n_streams, lambda: ns.init_state(cfg), step)
