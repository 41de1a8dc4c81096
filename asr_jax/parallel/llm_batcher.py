"""Continuous batching for the LLM-decoder ASR families (Qwen3-ASR /
Fun-ASR-Nano LLM head).

The reference's LLM runtime decodes one request at a time — one ONNX
launch per token, batch 1 (``Qwen_ASR/Inference_Qwen_ASR_ONNX.py``). This
repo's lockstep batch decode (``models/qwen_asr.transcribe_embeds``)
already amortizes the weight streaming over 8 concurrent utterances, but
it is a BARRIER: all 8 must arrive together and the batch runs to
completion before the next one starts. Under live traffic that leaves the
chip idle between batches and adds head-of-line latency.

Continuous batching removes the barrier with fixed shapes plus masks, never a recompile:

- The decode state is a fixed (n_slots, t_max) KV cache pytree plus
  per-slot position/count/active vectors; ONE jitted step advances every
  active slot by one token (``layers/qwen3.decoder_step_rowwise`` — each
  slot has its own compact cache and position, so slots are mutually
  invisible).
- A new request PREFILLS alone (its prompt length bucketed to a power of
  two so prefill executables are reused) and its KV rows are inserted
  into a free slot of the running batch; it starts decoding on the very
  next step, mid-flight of everyone else.
- A finished slot (EOT or token budget) frees immediately; the step
  masks it (``mode="drop"`` scatter: parked rows write nowhere).

Per-slot output is mathematically IDENTICAL to running that request
alone through ``transcribe_embeds`` (greedy/penalty: bitwise — masked
slots contribute exactly-zero attention; sampling: deterministic per
request — the slot's PRNG stream is reseeded from ``fold_in(base_key,
seed)`` at insert, so tokens depend only on (seed, own step index)),
tested in ``tests/test_llm_batcher.py``.
"""

from __future__ import annotations

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np

from asr_jax.decode.ar import DecodeConfig, select_token
from asr_jax.decode.strategies import suppress_tokens
from asr_jax.layers import qwen3


def _bucket(n: int, lo: int = 32) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class ContinuousLlmBatcher:
    """Slot-based continuous decode over one Qwen3 decoder.

    Thread model: all methods must be called from ONE driver thread (the
    server's ticker); HTTP handlers talk to the driver through queues.

    Args:
      llm_params: (fused) Qwen3 params pytree — same object the sessions
        hold; weights are shared, only the KV state is per-batcher.
      cfg: ``qwen3.Qwen3Config``.
      decode_cfg: strategy/penalty/sampling and ``max_new_tokens`` —
        identical semantics to the lockstep path (the per-slot generated
        budget is ``max_new_tokens + 1`` ids including EOT, matching
        ``ar_decode``).
      n_slots: concurrent requests riding one step dispatch.
      t_max: cache length per slot (>= longest prompt + budget).
      kv_dtype: cache storage dtype. The steady-state decode step is
        bounded by HBM reads of the KV cache (+ weights); ``bfloat16``
        halves the KV bytes (~35% faster steps measured at 0.6B
        geometry) at ~2^-8 relative KV rounding — output is then
        token-identical across slot layouts (the per-slot invariant)
        but no longer bitwise vs the f32-cache solo path.
      steps_per_tick: decode steps fused into ONE host dispatch
        (``lax.scan`` over the step body). Each :meth:`step_tick` then
        returns up to ``steps_per_tick`` tokens per slot for one host
        sync — the host<->device round trip amortizes over K tokens
        instead of paying per token. Token streams are IDENTICAL to K sequential
        :meth:`step` calls; the trade is join/free granularity — a
        request admits or frees only at tick boundaries, so a slot
        that hits EOT mid-tick stays parked (masked, zero attention)
        for the remainder of that tick.
      mesh: a ``jax.sharding.Mesh`` with a ``model`` axis — the batcher
        then runs TENSOR-PARALLEL: weights shard Megatron-style
        (``parallel.mesh.qwen3_param_specs``, the same specs the lockstep
        TP path uses), the KV cache shards over kv heads, and XLA/GSPMD
        inserts the collectives in the jitted step — exactly the
        mechanism proven by the lockstep ``--tensor-parallel`` path and
        ``__graft_entry__.dryrun_multichip``'s Qwen3 TP decode step. Requires
        ``num_heads`` and ``num_kv_heads`` divisible by the model-axis
        size. Output ids are identical to the unsharded batcher
        (tested on a virtual mesh).
    """

    def __init__(self, llm_params: dict, cfg: qwen3.Qwen3Config,
                 decode_cfg: DecodeConfig, n_slots: int = 8,
                 t_max: int = 1024, rng: jax.Array | None = None,
                 kv_dtype=jnp.float32, steps_per_tick: int = 1,
                 mesh=None):
        self.mesh = mesh
        if mesh is not None:
            tp = mesh.shape["model"]
            if cfg.num_heads % tp or cfg.num_kv_heads % tp:
                raise ValueError(
                    f"tensor-parallel size {tp} must divide num_heads="
                    f"{cfg.num_heads} and num_kv_heads={cfg.num_kv_heads}")
            from asr_jax.parallel.mesh import qwen3_param_specs, shard_params
            llm_params = shard_params(llm_params, mesh,
                                      qwen3_param_specs(llm_params))
        self.params = llm_params
        self.cfg = cfg
        self.dc = decode_cfg
        self.n_slots = int(n_slots)
        # rounded up to a multiple of 8 as the solo path's cache is; padded
        # slots are beyond every reachable position
        self.t_max = -(-int(t_max) // 8) * 8
        self.kv_dtype = kv_dtype
        self.gen_cap = decode_cfg.max_new_tokens + 1
        self.state = qwen3.make_kv_state(cfg, self.n_slots, self.t_max,
                                         kv_dtype)
        self.gen_buf = jnp.zeros((self.n_slots, self.gen_cap), jnp.int32)
        self.pos = jnp.zeros((self.n_slots,), jnp.int32)
        self.last = jnp.zeros((self.n_slots,), jnp.int32)
        self.count = jnp.zeros((self.n_slots,), jnp.int32)
        self.active = jnp.zeros((self.n_slots,), bool)
        # independent PRNG stream per slot: a slot's sample sequence does
        # not depend on which other slots are live (reproducible per request
        # — the slot key is reseeded from fold_in(base, seed) at insert)
        self._base_key = rng if rng is not None else jax.random.PRNGKey(0)
        self.keys = jax.random.split(self._base_key, self.n_slots)
        self._seed_counter = 0
        if mesh is not None:
            # Pin the decode state's layout: KV shards over kv heads (the
            # per-head attention never crosses shards; GSPMD all-reduces
            # only the o/down row-parallel matmuls), bookkeeping vectors
            # replicate.
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as P
            kvs = NamedSharding(mesh, P(None, None, "model", None))
            rep = NamedSharding(mesh, P())
            self.state = jax.tree.map(lambda x: jax.device_put(x, kvs),
                                      self.state)
            (self.gen_buf, self.pos, self.last, self.count, self.active,
             self.keys) = jax.device_put(
                (self.gen_buf, self.pos, self.last, self.count, self.active,
                 self.keys), rep)
        self._free = list(range(self.n_slots))
        # Host-side shadow of ``active``: liveness must never cost a
        # device->host fetch (each fetch is a round trip that would defeat
        # steps_per_tick's one-sync-per-tick design). Updated from values
        # already being fetched anyway.
        self._active_host = np.zeros(self.n_slots, bool)
        # Host mirror of each slot's generated ids: gen_buf[slot][:count]
        # is by construction [first token] + [every token the slot's step
        # events reported], so take_result/snapshot never fetch.
        self._gen_host: list[list[int]] = [[] for _ in range(self.n_slots)]
        self._lock = threading.Lock()
        self.steps_per_tick = max(int(steps_per_tick), 1)
        # substeps of the LAST tick that had >= 1 active slot (a tick whose
        # slots all finish early runs trailing no-op scan iterations; stats
        # must not count those as decode steps)
        self.last_tick_substeps = 0
        # jitted executables (shape-specialized per prefill bucket)
        self._prefill = jax.jit(self._prefill_impl)
        self._insert = jax.jit(self._insert_impl,
                               donate_argnums=(0, 1, 2, 3, 4, 5, 6))
        self._step = jax.jit(self._step_impl, donate_argnums=(0, 1, 2, 3, 4, 5, 6))
        self._step_n = jax.jit(self._step_n_impl,
                               donate_argnums=(0, 1, 2, 3, 4, 5, 6))

    # ── jitted impls ────────────────────────────────────────────────────────
    def _prefill_impl(self, params, embeds, valid, key):
        """(1, Lb, H) right-compacted prompt embeds -> (batch-1 kv state,
        first token, per-slot key advanced). Positions are cache slots
        (compact layout), exactly the solo path's logical positions.
        ``key`` is the request's derived PRNG key (see ``try_submit``)."""
        cfg, dc = self.cfg, self.dc
        state = qwen3.make_kv_state(cfg, 1, self.t_max, self.kv_dtype)
        bias = qwen3.causal_prefill_bias(valid, embeds.shape[1], self.t_max)
        hidden, state = qwen3.decoder_pass(
            params, cfg, embeds, state, jnp.asarray(0, jnp.int32), bias)
        h_last = jnp.take_along_axis(
            hidden, (valid - 1)[:, None, None].astype(jnp.int32), axis=1)[:, 0]
        logits0 = qwen3.logits_from_hidden(params, cfg, h_last)
        logits0 = suppress_tokens(logits0.astype(jnp.float32), dc.suppress_ids)
        empty = jnp.zeros((1, self.gen_cap), jnp.int32)
        first, _ = select_token(logits0, empty, jnp.zeros((1,), jnp.int32),
                                dc, key, history_start=0)
        return state, first[0]

    def _insert_impl(self, state, gen_buf, pos, last, count, active,
                     keys, small, slot, first, valid, key):
        state = jax.tree.map(lambda big, sm: big.at[slot].set(sm[0]),
                             state, small)
        row = jnp.zeros((self.gen_cap,), jnp.int32).at[0].set(first)
        gen_buf = gen_buf.at[slot].set(row)
        pos = pos.at[slot].set(valid)
        last = last.at[slot].set(first)
        count = count.at[slot].set(1)
        active = active.at[slot].set(
            (first != self.dc.eot_id) & (self.gen_cap > 1))
        # reseed the slot's PRNG stream from the request key (see try_submit)
        keys = keys.at[slot].set(key)
        return state, gen_buf, pos, last, count, active, keys

    def _step_impl(self, state, gen_buf, pos, last, count, active, keys,
                   params):
        # ``params`` ride as an ARGUMENT, never a closure: closed-over
        # device pytrees become trace-time HLO constants
        carry, (act, tok, fin) = self._step_body(
            (state, gen_buf, pos, last, count, active, keys), params)
        # ONE stacked (3, n_slots) int32 output: the host reads the step's
        # act/tok/fin planes in a single device->host transfer
        return (*carry, jnp.stack([act.astype(jnp.int32), tok,
                                   fin.astype(jnp.int32)]))

    def _step_n_impl(self, state, gen_buf, pos, last, count, active, keys,
                     params):
        """``steps_per_tick`` decode steps in ONE dispatch (lax.scan over
        the step body). The stacked (3, K, n_slots) int32 output holds the
        slot's active flag AT each substep, the token it produced, and
        whether it finished there — exactly what K sequential
        ``_step_impl`` calls would have reported, fetched in ONE
        device->host transfer."""

        def body(carry, _):
            return self._step_body(carry, params)

        carry, (act, tok, fin) = jax.lax.scan(
            body, (state, gen_buf, pos, last, count, active, keys),
            None, length=self.steps_per_tick)
        return (*carry, jnp.stack([act.astype(jnp.int32), tok,
                                   fin.astype(jnp.int32)]))

    def _step_body(self, carry, params):
        state, gen_buf, pos, last, count, active, keys = carry
        cfg, dc = self.cfg, self.dc
        emb = params["embed"][last][:, None].astype(jnp.float32)
        hidden, state = qwen3.decoder_step_rowwise(
            params, cfg, emb, state, pos, active)
        logits = qwen3.logits_from_hidden(params, cfg, hidden[:, -1])
        logits = suppress_tokens(logits.astype(jnp.float32), dc.suppress_ids)
        stepped = jax.vmap(jax.random.split)(keys)  # (B, 2, key)
        if dc.strategy == "sampling":
            # per-slot keys (a slot's sample stream is independent of which
            # other slots happen to be live): vmap the sampling path
            from asr_jax.decode.strategies import (
                apply_repetition_penalty, top_k_top_p_sample)
            lg = logits
            if dc.penalty != 1.0:
                lg = apply_repetition_penalty(
                    lg, gen_buf, count, dc.penalty, dc.penalty_range,
                    hist_start=0)
            tok = jax.vmap(
                lambda l, k: top_k_top_p_sample(
                    l[None], k, dc.temperature, dc.top_k, dc.top_p)[0]
            )(lg, stepped[:, 0])
        else:
            # greedy / penalty: deterministic — the key arg is unused
            tok, _ = select_token(logits, gen_buf, count, dc,
                                  jax.random.PRNGKey(0), history_start=0)
        # Advance EVERY slot's key iff the engine stepped (any slot active)
        # — exactly the sequential contract: step() early-returns without
        # splitting when nothing is active, so trailing all-inactive
        # substeps of a tick must leave key state untouched or a request
        # joining a freed slot would sample a different stream than under
        # steps_per_tick=1.
        keys = jnp.where(jnp.any(active), stepped[:, 1], keys)
        tok = jnp.where(active, tok, jnp.int32(dc.eot_id)).astype(jnp.int32)
        wslot = jnp.where(active, jnp.minimum(count, self.gen_cap - 1),
                          self.gen_cap)  # parked rows write nowhere
        gen_buf = gen_buf.at[jnp.arange(self.n_slots), wslot].set(
            tok, mode="drop")
        count = count + active.astype(jnp.int32)
        pos = pos + active.astype(jnp.int32)
        still = active & (tok != dc.eot_id) & (count < self.gen_cap)
        finished_now = active & ~still
        return ((state, gen_buf, pos, tok, count, still, keys),
                (active, tok, finished_now))

    # ── driver API ──────────────────────────────────────────────────────────
    def try_submit(self, embeds: jnp.ndarray, valid_len: int,
                   seed: int | None = None) -> int | None:
        """Prefill one request and join the running batch.

        Args:
          embeds: (L, H) or (1, L, H) prompt embeds, valid prefix FIRST
            (``assemble_prompt``'s right-padded layout, or exactly L valid).
          valid_len: number of valid leading positions.
          seed: optional per-request PRNG seed — the slot key is reseeded
            to ``fold_in(base_key, seed)`` at insert so sampled tokens are
            a deterministic function of (seed, own step index), independent
            of engine history and sibling slots. Defaults to a monotonic
            counter.

        Returns the slot id, or None when all slots are busy. The first
        generated token is available immediately via :meth:`snapshot`.
        """
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop(0)
            seed_i = self._seed_counter if seed is None else int(seed)
            self._seed_counter += 1
        if embeds.ndim == 2:
            embeds = embeds[None]
        lb = _bucket(embeds.shape[1])
        if lb + self.gen_cap > self.t_max:
            with self._lock:
                self._free.insert(0, slot)
            raise ValueError(
                f"prompt bucket {lb} + budget {self.gen_cap} exceeds t_max "
                f"{self.t_max}")
        if embeds.shape[1] != lb:
            embeds = jnp.pad(embeds, ((0, 0), (0, lb - embeds.shape[1]), (0, 0)))
        if self.mesh is not None:
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as P
            embeds = jax.device_put(jnp.asarray(embeds),
                                    NamedSharding(self.mesh, P()))
        req_key = jax.random.fold_in(self._base_key, seed_i)
        k_first, k_slot = jax.random.split(req_key)
        small, first = self._prefill(
            self.params, embeds, jnp.asarray([valid_len], jnp.int32), k_first)
        (self.state, self.gen_buf, self.pos, self.last, self.count,
         self.active, self.keys) = self._insert(
            self.state, self.gen_buf, self.pos, self.last, self.count,
            self.active, self.keys, small, jnp.asarray(slot, jnp.int32), first,
            jnp.asarray(valid_len, jnp.int32), k_slot)
        # mirror _insert's active formula host-side (``first`` is tiny and
        # the caller needs it via snapshot/is_active anyway)
        first_h = int(np.asarray(first))
        self._active_host[slot] = (first_h != self.dc.eot_id
                                   and self.gen_cap > 1)
        self._gen_host[slot] = [first_h]
        return slot

    def step(self) -> list[tuple[int, int, bool]]:
        """Advance every active slot one token.

        Returns ``[(slot, token, finished), ...]`` for slots that were
        active this step; a finished slot is freed AFTER the caller drains
        it with :meth:`take_result`.
        """
        was_active = self._active_host.copy()
        if not was_active.any():
            self.last_tick_substeps = 0
            return []
        self.last_tick_substeps = 1
        (self.state, self.gen_buf, self.pos, self.last, self.count,
         self.active, self.keys, out) = self._step(
            self.state, self.gen_buf, self.pos, self.last, self.count,
            self.active, self.keys, self.params)
        _, tok_h, fin_h = np.asarray(out)  # ONE fetch: (3, n_slots)
        fin_h = fin_h.astype(bool)
        self._active_host = was_active & ~fin_h
        events = [(i, int(tok_h[i]), bool(fin_h[i]))
                  for i in range(self.n_slots) if was_active[i]]
        for i, t, _f in events:
            self._gen_host[i].append(t)
        return events

    def step_tick(self) -> list[tuple[int, int, bool]]:
        """Advance every active slot ``steps_per_tick`` tokens in ONE
        dispatch + ONE host sync.

        Returns the same ``[(slot, token, finished), ...]`` stream K
        sequential :meth:`step` calls would, in substep order. With
        ``steps_per_tick == 1`` this IS :meth:`step`."""
        if self.steps_per_tick == 1:
            return self.step()
        if not self._active_host.any():
            self.last_tick_substeps = 0
            return []
        (self.state, self.gen_buf, self.pos, self.last, self.count,
         self.active, self.keys, out) = self._step_n(
            self.state, self.gen_buf, self.pos, self.last, self.count,
            self.active, self.keys, self.params)
        act_h, tok_h, fin_h = np.asarray(out)  # ONE fetch: (3, K, n_slots)
        act_h = act_h.astype(bool)
        fin_h = fin_h.astype(bool)
        self.last_tick_substeps = int(act_h.any(axis=1).sum())
        # live after the tick = live at the last substep and not finished
        # there (a slot finishing earlier has act False from then on)
        self._active_host = act_h[-1] & ~fin_h[-1]
        events = [(i, int(tok_h[s, i]), bool(fin_h[s, i]))
                  for s in range(act_h.shape[0])
                  for i in range(self.n_slots) if act_h[s, i]]
        for i, t, _f in events:
            self._gen_host[i].append(t)
        return events

    def take_result(self, slot: int) -> list[int]:
        """Generated ids of a finished slot (EOT included when produced);
        frees the slot for the next request. Zero device fetches: the ids
        are the host mirror of gen_buf[slot][:count]."""
        ids = list(self._gen_host[slot])
        with self._lock:
            if slot not in self._free:
                self._free.append(slot)
        return ids

    def cancel(self, slot: int) -> None:
        """Deactivate a slot without draining its result (warmup, or the
        client went away); the slot is free for the next request."""
        self.active = self.active.at[slot].set(False)
        self._active_host[slot] = False
        with self._lock:
            if slot not in self._free:
                self._free.append(slot)

    def is_active(self, slot: int) -> bool:
        """Whether the slot is still generating (False right after submit
        means the FIRST token already ended the request — EOT or a budget
        of one — and :meth:`step` will never report it: drain it now)."""
        return bool(self._active_host[slot])

    def snapshot(self, slot: int) -> list[int]:
        """Generated ids so far (incremental reads while decoding);
        zero device fetches (host mirror)."""
        return list(self._gen_host[slot])

    @property
    def n_active(self) -> int:
        return int(self._active_host.sum())
