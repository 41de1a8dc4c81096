"""Continuous batching for the AED encoder-decoder families (Whisper /
FireRedASR-AED / Dolphin).

The reference serves these families one request at a time — one ONNX
launch per token, batch 1 (``Whisper/Inference_Whisper_ONNX.py:584-663``).
This repo's lockstep micro-batcher already amortizes the decoder weight
streaming over 8 concurrent windows, but it is a BARRIER: a late arrival
waits out the running batch's ~200-step decode (head-of-line latency the
r4 verdict called the framework's weakest serving story, since Whisper is
the single most-served ASR workload).

This engine removes the barrier exactly the way ``llm_batcher.py`` did
for the LLM families — fixed shapes plus masks, never a recompile — with
the AED-specific twist that each slot carries PER-SLOT CROSS-KV (its own
encoder output) next to the usual compact self-KV:

- Decode state: (NL, n_slots, T_self, D) self-KV planes, (NL, n_slots,
  Tc, D) cross-KV planes, per-slot ``tc_valid`` / position / count /
  active vectors. ONE jitted step advances every active slot by one
  token.
- A new request PREFILLS alone through the family's own solo path
  (encoder + probe + prompt prefill — the session supplies the batch-1
  state pytree and first-step logits), then its KV rows and cross planes
  are inserted into a free slot of the running batch; it decodes on the
  very next step, mid-flight of everyone else.
- A finished slot (EOT or budget) frees immediately; parked slots write
  nowhere (``mode="drop"`` scatter) and contribute finite garbage the
  host discards.

Per-slot output is mathematically IDENTICAL to running that request
alone through the family's ``transcribe`` loop (greedy/penalty: bitwise —
the rowwise step attends over the same padded cache length with
exactly-zero masked contributions; sampling: deterministic per request —
the slot's PRNG stream is reseeded from ``fold_in(base_key, seed)`` at
insert, so tokens depend only on (seed, own step index), never on engine
history or sibling slots), tested in ``tests/test_aed_batcher.py``.
"""

from __future__ import annotations

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np

from asr_jax.decode.ar import DecodeConfig, select_token
from asr_jax.decode.strategies import suppress_tokens
from asr_jax.layers.attention import NEG_INF, mha
from asr_jax.layers.norms import layer_norm
from asr_jax.layers.transformer import dense, merge_heads, split_heads
from asr_jax.quant.quantize import embedding_logits


@dataclasses.dataclass(frozen=True)
class AedEngineSpec:
    """Decoder geometry + input-math convention (hashable, rides jit)."""

    d_model: int
    ffn_dim: int
    num_heads: int
    vocab_size: int
    t_max: int                 # self-cache length == solo max_target_positions
    tc_max: int                # cross length (fixed window -> fixed encoder len)
    embed: str                 # "learned" (Whisper) | "scaled_relpos" (FireRed/Dolphin)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def spec_for_whisper(cfg) -> AedEngineSpec:
    return AedEngineSpec(
        d_model=cfg.d_model, ffn_dim=cfg.ffn_dim, num_heads=cfg.num_heads,
        vocab_size=cfg.vocab_size, t_max=cfg.max_target_positions,
        tc_max=cfg.max_source_positions, embed="learned")


def spec_for_aed(cfg, tc_max: int) -> AedEngineSpec:
    """FireRed / Dolphin: sqrt(d)-scaled embeds + reversed-relative PE."""
    return AedEngineSpec(
        d_model=cfg.d_model, ffn_dim=cfg.dec_ffn, num_heads=cfg.dec_heads,
        vocab_size=cfg.vocab_size, t_max=cfg.max_target_positions,
        tc_max=tc_max, embed="scaled_relpos")


def _embed_rows(dec: dict, spec: AedEngineSpec, tokens: jnp.ndarray,
                pos: jnp.ndarray) -> jnp.ndarray:
    """Family input math for one token per slot -> (B, D) f32 rows.

    learned: ``embed[token] + pos_table[pos]`` (Whisper,
    ``models/whisper._decoder_pass``); scaled_relpos:
    ``embed[token] * sqrt(d) + reversed-relative-PE[pos]``
    (``models/firered._decoder_pass`` / ``models/dolphin._decoder_pass``).
    """
    d = spec.d_model
    logical = jnp.clip(pos, 0, spec.t_max - 1)
    if spec.embed == "learned":
        x = dec["embed"][tokens] + jnp.take(dec["pos"], logical, axis=0)
    else:
        from asr_jax.layers.conformer import relative_position_embedding

        pe = jnp.asarray(relative_position_embedding(spec.t_max, d))
        pos_table = pe[: spec.t_max][::-1]
        x = dec["embed"][tokens] * (d ** 0.5) + jnp.take(pos_table, logical, axis=0)
    return x.astype(jnp.float32)


def aed_decoder_step_rowwise(
    dec: dict,
    spec: AedEngineSpec,
    x: jnp.ndarray,
    state: dict,
    pos: jnp.ndarray,
    tc_valid: jnp.ndarray,
    active: jnp.ndarray,
) -> tuple[jnp.ndarray, dict]:
    """One decode token through all AED decoder blocks with PER-ROW cache
    positions.

    Per-row math is IDENTICAL to running that row alone through
    ``layers/transformer.decoder_block``: both attend over the same padded
    ``t_max`` cache with masked slots contributing exactly-zero
    probability, so reductions agree bitwise (the ``qwen3
    .decoder_step_rowwise`` argument, proven by ``tests/test_llm_batcher``).

    Args:
      x: (B, 1, D) current-token rows (family input math applied).
      state: ``{"layers": ({"self_k"/"self_v" (B, T, H, hd),
        "cross_k"/"cross_v" (B, Tc, H, hd)}, ...)}`` — the solo
        ``make_state`` layout with a slot batch axis.
      pos: (B,) int32 — cache slot to write (prompt_len + generated count).
      tc_valid: (B,) int32 — valid cross rows per slot.
      active: (B,) bool — parked rows write nowhere.

    Returns (hidden (B, 1, D) final-normalized, new state).
    """
    t_max = state["layers"][0]["self_k"].shape[1]
    tc = state["layers"][0]["cross_k"].shape[1]
    b = x.shape[0]
    bidx = jnp.arange(b, dtype=jnp.int32)
    logical = jnp.clip(pos, 0, t_max - 1)
    wpos = jnp.where(active, logical, t_max)  # mode="drop" parks inactive rows
    kpos = jnp.arange(t_max, dtype=jnp.int32)[None, :]
    self_bias = jnp.where(kpos <= logical[:, None], 0.0,
                          NEG_INF)[:, None, None].astype(jnp.float32)
    cpos = jnp.arange(tc, dtype=jnp.int32)[None, :]
    cross_bias = jnp.where(cpos < tc_valid[:, None], 0.0,
                           NEG_INF)[:, None, None].astype(jnp.float32)

    h = spec.num_heads
    new_layers = []
    for p, lstate in zip(dec["blocks"], state["layers"]):
        y = layer_norm(x, p["ln1"]["scale"], p["ln1"]["bias"])
        q = split_heads(dense(y, p["attn"]["q"]), h)
        k = split_heads(dense(y, p["attn"]["k"]), h)
        v = split_heads(dense(y, p["attn"]["v"]), h)
        k_cache = lstate["self_k"].at[bidx, wpos].set(
            k[:, 0].astype(lstate["self_k"].dtype), mode="drop")
        v_cache = lstate["self_v"].at[bidx, wpos].set(
            v[:, 0].astype(lstate["self_v"].dtype), mode="drop")
        attn = mha(q, k_cache, v_cache, bias=self_bias)
        x = x + dense(merge_heads(attn), p["attn"]["o"])

        y = layer_norm(x, p["ln_cross"]["scale"], p["ln_cross"]["bias"])
        qc = split_heads(dense(y, p["cross"]["q"]), h)
        xc = mha(qc, lstate["cross_k"], lstate["cross_v"], bias=cross_bias)
        x = x + dense(merge_heads(xc), p["cross"]["o"])

        y = layer_norm(x, p["ln2"]["scale"], p["ln2"]["bias"])
        hh = jax.nn.gelu(dense(y, p["mlp"]["fc1"]), approximate=False)
        x = x + dense(hh, p["mlp"]["fc2"])
        new_layers.append({**lstate, "self_k": k_cache, "self_v": v_cache})
    x = layer_norm(x, dec["ln"]["scale"], dec["ln"]["bias"])
    return x, {"layers": tuple(new_layers)}


class ContinuousAedBatcher:
    """Slot-based continuous decode over one AED decoder.

    Thread model: all methods from ONE driver thread (the server's
    ticker), exactly :class:`~asr_jax.parallel.llm_batcher
    .ContinuousLlmBatcher`'s contract — the driver API (``try_submit`` /
    ``step`` / ``step_tick`` / ``take_result`` / ``cancel`` /
    ``is_active`` / ``snapshot``) is interface-identical so the serving
    layer treats both engines uniformly.

    Args:
      params: the family's params pytree (``params["decoder"]`` holds the
        ``layers/transformer.decoder_block`` blocks + embed/pos/ln[/out]).
      spec: :class:`AedEngineSpec`.
      decode_cfg: strategy/penalty/sampling + ``max_new_tokens`` —
        identical semantics to the solo ``ar_decode`` loop.
      n_slots: concurrent requests riding one step dispatch.
      kv_dtype: self/cross cache storage dtype (bf16 halves the dominant
        per-step HBM read: the per-slot cross-KV).
      steps_per_tick: decode steps fused into one host dispatch
        (``lax.scan``), same trade as the LLM engine's ``--steps-per-tick``.
    """

    def __init__(self, params: dict, spec: AedEngineSpec,
                 decode_cfg: DecodeConfig, n_slots: int = 8,
                 rng: jax.Array | None = None, kv_dtype=jnp.float32,
                 steps_per_tick: int = 1):
        self.dec = params["decoder"]
        self.spec = spec
        self.dc = decode_cfg
        self.n_slots = int(n_slots)
        if self.n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.kv_dtype = kv_dtype
        self.gen_cap = decode_cfg.max_new_tokens + 1
        h, hd = spec.num_heads, spec.head_dim
        layers = tuple(
            {"self_k": jnp.zeros((self.n_slots, spec.t_max, h, hd), kv_dtype),
             "self_v": jnp.zeros((self.n_slots, spec.t_max, h, hd), kv_dtype),
             "cross_k": jnp.zeros((self.n_slots, spec.tc_max, h, hd), kv_dtype),
             "cross_v": jnp.zeros((self.n_slots, spec.tc_max, h, hd), kv_dtype)}
            for _ in self.dec["blocks"])
        self.state = {"layers": layers}
        self.gen_buf = jnp.zeros((self.n_slots, self.gen_cap), jnp.int32)
        self.pos = jnp.zeros((self.n_slots,), jnp.int32)       # p_len + count
        self.tc_valid = jnp.zeros((self.n_slots,), jnp.int32)
        self.last = jnp.zeros((self.n_slots,), jnp.int32)
        self.count = jnp.zeros((self.n_slots,), jnp.int32)
        self.active = jnp.zeros((self.n_slots,), bool)
        self._base_key = rng if rng is not None else jax.random.PRNGKey(0)
        self.keys = jax.random.split(self._base_key, self.n_slots)
        self._seed_counter = 0  # per-request PRNG derivation (try_submit)
        self._free = list(range(self.n_slots))
        self._active_host = np.zeros(self.n_slots, bool)
        self._gen_host: list[list[int]] = [[] for _ in range(self.n_slots)]
        self._lock = threading.Lock()
        self.steps_per_tick = max(int(steps_per_tick), 1)
        self.last_tick_substeps = 0
        self._insert = jax.jit(self._insert_impl,
                               donate_argnums=(0, 1, 2, 3, 4, 5, 6, 7))
        self._first = jax.jit(self._first_impl)
        self._step = jax.jit(self._step_impl,
                             donate_argnums=(0, 1, 2, 3, 4, 5, 6, 7))
        self._step_n = jax.jit(self._step_n_impl,
                               donate_argnums=(0, 1, 2, 3, 4, 5, 6, 7))

    # ── jitted impls ────────────────────────────────────────────────────────
    def _first_impl(self, logits0, key):
        """First generated token from the session's (already suppressed +
        begin-suppressed) prefill logits — same strategy routing as every
        later step (the solo path feeds prefill logits through
        ``select_token`` too, ``models/whisper.transcribe_window``).
        ``key`` is the request's derived PRNG key (see ``try_submit``)."""
        empty = jnp.zeros((1, self.gen_cap), jnp.int32)
        first, _ = select_token(logits0.astype(jnp.float32), empty,
                                jnp.zeros((1,), jnp.int32), self.dc,
                                key, history_start=0)
        return first[0]

    def _insert_impl(self, state, gen_buf, pos, tc_valid, last, count, active,
                     keys, small, slot, first, p_len, tc_v, key):
        state = jax.tree.map(
            lambda big, sm: big.at[slot].set(sm[0].astype(big.dtype)),
            state, small)
        row = jnp.zeros((self.gen_cap,), jnp.int32).at[0].set(first)
        gen_buf = gen_buf.at[slot].set(row)
        pos = pos.at[slot].set(p_len)
        tc_valid = tc_valid.at[slot].set(tc_v)
        last = last.at[slot].set(first)
        count = count.at[slot].set(1)
        active = active.at[slot].set(
            (first != self.dc.eot_id) & (self.gen_cap > 1))
        # reseed the slot's PRNG stream from the request key: sampled
        # tokens become a deterministic function of (request seed, own
        # step index) — independent of engine history and sibling slots
        keys = keys.at[slot].set(key)
        return state, gen_buf, pos, tc_valid, last, count, active, keys

    def _step_impl(self, state, gen_buf, pos, tc_valid, last, count, active,
                   keys, dec):
        carry, (act, tok, fin) = self._step_body(
            (state, gen_buf, pos, tc_valid, last, count, active, keys), dec)
        return (*carry, jnp.stack([act.astype(jnp.int32), tok,
                                   fin.astype(jnp.int32)]))

    def _step_n_impl(self, state, gen_buf, pos, tc_valid, last, count, active,
                     keys, dec):
        def body(carry, _):
            return self._step_body(carry, dec)

        carry, (act, tok, fin) = jax.lax.scan(
            body, (state, gen_buf, pos, tc_valid, last, count, active, keys),
            None, length=self.steps_per_tick)
        return (*carry, jnp.stack([act.astype(jnp.int32), tok,
                                   fin.astype(jnp.int32)]))

    def _step_body(self, carry, dec):
        state, gen_buf, pos, tc_valid, last, count, active, keys = carry
        spec, dc = self.spec, self.dc
        x = _embed_rows(dec, spec, last, pos)
        hidden, state = aed_decoder_step_rowwise(
            dec, spec, x[:, None], state, pos, tc_valid, active)
        head = dec["out"] if "out" in dec else dec["embed"]
        logits = embedding_logits(head, hidden[:, -1])
        logits = suppress_tokens(logits.astype(jnp.float32), dc.suppress_ids)
        stepped = jax.vmap(jax.random.split)(keys)
        if dc.strategy == "sampling":
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
            tok, _ = select_token(logits, gen_buf, count, dc,
                                  jax.random.PRNGKey(0), history_start=0)
        keys = jnp.where(jnp.any(active), stepped[:, 1], keys)
        tok = jnp.where(active, tok, jnp.int32(dc.eot_id)).astype(jnp.int32)
        wslot = jnp.where(active, jnp.minimum(count, self.gen_cap - 1),
                          self.gen_cap)
        gen_buf = gen_buf.at[jnp.arange(self.n_slots), wslot].set(
            tok, mode="drop")
        count = count + active.astype(jnp.int32)
        pos = pos + active.astype(jnp.int32)
        still = (active & (tok != dc.eot_id) & (count < self.gen_cap)
                 & (pos < spec.t_max))
        finished_now = active & ~still
        return ((state, gen_buf, pos, tc_valid, tok, count, still, keys),
                (active, tok, finished_now))

    # ── driver API (interface-identical to ContinuousLlmBatcher) ────────────
    def try_submit(self, small_state: dict, p_len: int, logits0,
                   tc_valid: int, seed: int | None = None) -> int | None:
        """Insert one prefilled request into a free slot.

        Args:
          small_state: batch-1 state pytree from the family's
            ``make_state`` + prompt prefill (solo layout: per-layer
            self/cross KV). Cross length must be <= ``spec.tc_max``.
          p_len: prompt length (the prompt occupies self-cache [0, p_len)).
          logits0: (1, V) prefill logits, already suppressed (+
            begin-suppressed for Whisper).
          tc_valid: number of REAL cross rows for this request.
          seed: optional per-request PRNG seed. The slot's key is reseeded
            to ``fold_in(base_key, seed)`` at insert, so sampled tokens are
            a deterministic function of (seed, own step index) — NOT of
            engine history or sibling slots. Defaults to a monotonically
            increasing counter (distinct streams, fresh each request).

        Returns the slot id, or None when all slots are busy.
        """
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop(0)
            seed_i = self._seed_counter if seed is None else int(seed)
            self._seed_counter += 1
        if p_len + self.gen_cap > self.spec.t_max:
            with self._lock:
                self._free.insert(0, slot)
            raise ValueError(
                f"prompt {p_len} + budget {self.gen_cap} exceeds t_max "
                f"{self.spec.t_max}")
        req_key = jax.random.fold_in(self._base_key, seed_i)
        k_first, k_slot = jax.random.split(req_key)
        first = self._first(jnp.asarray(logits0), k_first)
        (self.state, self.gen_buf, self.pos, self.tc_valid, self.last,
         self.count, self.active, self.keys) = self._insert(
            self.state, self.gen_buf, self.pos, self.tc_valid, self.last,
            self.count, self.active, self.keys, small_state,
            jnp.asarray(slot, jnp.int32), first,
            jnp.asarray(p_len, jnp.int32), jnp.asarray(tc_valid, jnp.int32),
            k_slot)
        first_h = int(np.asarray(first))
        self._active_host[slot] = (first_h != self.dc.eot_id
                                   and self.gen_cap > 1)
        self._gen_host[slot] = [first_h]
        return slot

    def step(self) -> list[tuple[int, int, bool]]:
        was_active = self._active_host.copy()
        if not was_active.any():
            self.last_tick_substeps = 0
            return []
        self.last_tick_substeps = 1
        (self.state, self.gen_buf, self.pos, self.tc_valid, self.last,
         self.count, self.active, self.keys, out) = self._step(
            self.state, self.gen_buf, self.pos, self.tc_valid, self.last,
            self.count, self.active, self.keys, self.dec)
        _, tok_h, fin_h = np.asarray(out)  # ONE fetch: (3, n_slots)
        fin_h = fin_h.astype(bool)
        self._active_host = was_active & ~fin_h
        events = [(i, int(tok_h[i]), bool(fin_h[i]))
                  for i in range(self.n_slots) if was_active[i]]
        for i, t, _f in events:
            self._gen_host[i].append(t)
        return events

    def step_tick(self) -> list[tuple[int, int, bool]]:
        if self.steps_per_tick == 1:
            return self.step()
        if not self._active_host.any():
            self.last_tick_substeps = 0
            return []
        (self.state, self.gen_buf, self.pos, self.tc_valid, self.last,
         self.count, self.active, self.keys, out) = self._step_n(
            self.state, self.gen_buf, self.pos, self.tc_valid, self.last,
            self.count, self.active, self.keys, self.dec)
        act_h, tok_h, fin_h = np.asarray(out)  # ONE fetch: (3, K, n_slots)
        act_h = act_h.astype(bool)
        fin_h = fin_h.astype(bool)
        self.last_tick_substeps = int(act_h.any(axis=1).sum())
        self._active_host = act_h[-1] & ~fin_h[-1]
        events = [(i, int(tok_h[s, i]), bool(fin_h[s, i]))
                  for s in range(act_h.shape[0])
                  for i in range(self.n_slots) if act_h[s, i]]
        for i, t, _f in events:
            self._gen_host[i].append(t)
        return events

    def take_result(self, slot: int) -> list[int]:
        ids = list(self._gen_host[slot])
        with self._lock:
            if slot not in self._free:
                self._free.append(slot)
        return ids

    def cancel(self, slot: int) -> None:
        self.active = self.active.at[slot].set(False)
        self._active_host[slot] = False
        with self._lock:
            if slot not in self._free:
                self._free.append(slot)

    def is_active(self, slot: int) -> bool:
        return bool(self._active_host[slot])

    def snapshot(self, slot: int) -> list[int]:
        return list(self._gen_host[slot])

    @property
    def n_active(self) -> int:
        return int(self._active_host.sum())
