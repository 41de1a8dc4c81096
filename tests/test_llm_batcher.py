"""Continuous LLM batching: per-slot output must be token-identical to the
proven solo lockstep path (``models/qwen_asr.transcribe_embeds``) even when
requests join mid-flight of other requests' decodes; slots free and reuse;
the rowwise decode step matches ``decoder_pass`` numerically."""

import numpy as np
import jax
import jax.numpy as jnp

from asr_jax.decode.ar import DecodeConfig
from asr_jax.layers import qwen3
from asr_jax.models import qwen_asr as qa
from asr_jax.parallel.llm_batcher import ContinuousLlmBatcher

CFG = qwen3.Qwen3Config(
    vocab_size=96, hidden=48, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=16, ffn_dim=64, rope_theta=10000.0, max_seq_len=128,
)
EOT = 7
DC = DecodeConfig(max_new_tokens=8, eot_id=EOT)


def _params():
    return qwen3.init_params(CFG, jax.random.PRNGKey(0))


def _embeds(params, ids):
    return params["embed"][jnp.asarray([ids], jnp.int32)]


def _solo(params, ids, dc=DC):
    """Reference: the lockstep batch-1 path."""
    emb = _embeds(params, ids)
    acfg = qa.QwenAsrConfig(llm=CFG, eot_id=dc.eot_id)
    tokens, counts, start = qa.transcribe_embeds(
        params, acfg, emb, jnp.asarray([len(ids)], jnp.int32), dc)
    lf = int(start[0])
    return [int(t) for t in np.asarray(tokens)[0, lf:lf + int(counts[0])]]


def test_rowwise_step_matches_decoder_pass():
    """One rowwise step (equal positions) == one lockstep decoder_pass step
    on a compact cache."""
    params = _params()
    t_max = 32
    ids = np.array([[3, 11, 42, 5], [9, 1, 88, 64]], np.int32)
    valid = jnp.asarray([4, 4], jnp.int32)
    emb = params["embed"][jnp.asarray(ids)]
    state0 = qwen3.make_kv_state(CFG, 2, t_max)
    bias = qwen3.causal_prefill_bias(valid, 4, t_max)
    h, state = qwen3.decoder_pass(params, CFG, emb, state0,
                                  jnp.asarray(0, jnp.int32), bias)
    nxt = params["embed"][jnp.asarray([[17], [23]], jnp.int32)]

    sb = qwen3.step_bias(valid, jnp.asarray(4, jnp.int32), t_max)
    h_ref, st_ref = qwen3.decoder_pass(params, CFG, nxt, state,
                                       jnp.asarray(4, jnp.int32), sb)
    h_row, st_row = qwen3.decoder_step_rowwise(
        params, CFG, nxt, state, jnp.asarray([4, 4], jnp.int32))
    np.testing.assert_allclose(np.asarray(h_row), np.asarray(h_ref),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(st_row["layers"], st_ref["layers"]):
        np.testing.assert_allclose(np.asarray(a["k"]), np.asarray(b["k"]),
                                   rtol=1e-5, atol=1e-6)


def test_rowwise_inactive_rows_untouched():
    params = _params()
    t_max = 32
    state = qwen3.make_kv_state(CFG, 2, t_max)
    marker = state["layers"][0]["k"].at[1].set(3.25)
    state["layers"] = (dict(state["layers"][0], k=marker),) + state["layers"][1:]
    nxt = params["embed"][jnp.asarray([[4], [4]], jnp.int32)]
    _, st = qwen3.decoder_step_rowwise(
        params, CFG, nxt, state, jnp.asarray([0, 5], jnp.int32),
        active=jnp.asarray([True, False]))
    k = np.asarray(st["layers"][0]["k"])
    assert (k[1] == 3.25).all()          # parked row wrote nowhere
    assert (k[0, 0] != 0).any()          # active row wrote slot 0


def _drain(bat, slots, got):
    """Step until every tracked slot finishes; collect ids."""
    for _ in range(DC.max_new_tokens + 2):
        events = bat.step()
        if not events:
            break
        for slot, tok, fin in events:
            if fin and slot in slots:
                got[slots[slot]] = bat.take_result(slot)
                del slots[slot]
    return got


def test_continuous_matches_solo_with_staggered_joins():
    params = _params()
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, CFG.vocab_size, size=n))
               for n in (3, 6, 11, 4, 9)]
    want = [_solo(params, p) for p in prompts]

    bat = ContinuousLlmBatcher(params, CFG, DC, n_slots=3, t_max=64)
    slots = {}   # device slot -> request index
    got = [None] * len(prompts)
    # join 0 and 1 together
    for r in (0, 1):
        s = bat.try_submit(_embeds(params, prompts[r])[0], len(prompts[r]))
        assert s is not None
        slots[s] = r
    # two steps mid-flight, then request 2 JOINS the running batch
    for _ in range(2):
        for slot, tok, fin in bat.step():
            if fin:
                got[slots[slot]] = bat.take_result(slot)
                del slots[slot]
    s = bat.try_submit(_embeds(params, prompts[2])[0], len(prompts[2]))
    assert s is not None
    slots[s] = 2
    got = _drain(bat, slots, got)
    # late requests after the batch drained
    for r in (3, 4):
        s = bat.try_submit(_embeds(params, prompts[r])[0], len(prompts[r]))
        slots[s] = r
    got = _drain(bat, slots, got)

    for r, (g, w) in enumerate(zip(got, want)):
        assert g == w, (r, g, w)


def test_slot_exhaustion_and_reuse():
    params = _params()
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(0, CFG.vocab_size, size=5)) for _ in range(3)]
    bat = ContinuousLlmBatcher(params, CFG, DC, n_slots=2, t_max=64)
    s0 = bat.try_submit(_embeds(params, prompts[0])[0], 5)
    s1 = bat.try_submit(_embeds(params, prompts[1])[0], 5)
    assert s0 is not None and s1 is not None
    assert bat.try_submit(_embeds(params, prompts[2])[0], 5) is None  # full
    slots = {s0: 0, s1: 1}
    got = _drain(bat, slots, [None] * 3)
    s2 = bat.try_submit(_embeds(params, prompts[2])[0], 5)  # slot reused
    assert s2 is not None
    slots = {s2: 2}
    got = _drain(bat, slots, got)
    for r in range(3):
        assert got[r] == _solo(params, prompts[r]), r


def test_penalty_strategy_matches_solo():
    params = _params()
    dc = DecodeConfig(max_new_tokens=8, eot_id=EOT, strategy="penalty",
                      penalty=1.5, penalty_range=4)
    rng = np.random.default_rng(2)
    prompts = [list(rng.integers(0, CFG.vocab_size, size=n)) for n in (4, 7)]
    want = [_solo(params, p, dc) for p in prompts]
    bat = ContinuousLlmBatcher(params, CFG, dc, n_slots=2, t_max=64)
    slots = {}
    for r in range(2):
        slots[bat.try_submit(_embeds(params, prompts[r])[0], len(prompts[r]))] = r
    got = [None, None]
    for _ in range(dc.max_new_tokens + 2):
        evs = bat.step()
        if not evs:
            break
        for slot, tok, fin in evs:
            if fin:
                got[slots[slot]] = bat.take_result(slot)
    for r in range(2):
        assert got[r] == want[r], (r, got[r], want[r])


def test_bf16_cache_slot_layout_invariance():
    """kv_dtype=bf16: a request's output must not depend on WHICH slot it
    lands in or which other requests are live (the per-slot invariant the
    docstring promises) — checked by running the same prompts solo-in-batcher
    vs packed together. bf16 rounds the cache, so the reference here is the
    bf16 batcher itself, not the f32 solo path."""
    params = _params()
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(0, CFG.vocab_size, size=n)) for n in (5, 8, 3)]

    def run_alone(p):
        bat = ContinuousLlmBatcher(params, CFG, DC, n_slots=3, t_max=64,
                                   kv_dtype=jnp.bfloat16)
        slot = bat.try_submit(_embeds(params, p)[0], len(p))
        slots = {slot: 0}
        return _drain(bat, slots, [None])[0]

    want = [run_alone(p) for p in prompts]

    bat = ContinuousLlmBatcher(params, CFG, DC, n_slots=3, t_max=64,
                               kv_dtype=jnp.bfloat16)
    # occupy slot 0 first so request 0 lands in a DIFFERENT slot than solo
    s_pad = bat.try_submit(_embeds(params, prompts[2])[0], len(prompts[2]))
    slots = {s_pad: 2}
    got = [None] * 3
    for r in (0, 1):
        slots[bat.try_submit(_embeds(params, prompts[r])[0], len(prompts[r]))] = r
    got = _drain(bat, slots, got)
    for r in range(3):
        assert got[r] == want[r], (r, got[r], want[r])


def test_incremental_snapshot_is_prefix():
    params = _params()
    prompt = [3, 14, 15, 92, 65]
    bat = ContinuousLlmBatcher(params, CFG, DC, n_slots=1, t_max=64)
    slot = bat.try_submit(_embeds(params, prompt)[0], len(prompt))
    seen = bat.snapshot(slot)
    assert len(seen) == 1  # first token available right after prefill
    final = None
    while final is None:
        evs = bat.step()
        snap = bat.snapshot(slot)
        assert snap[:len(seen)] == seen  # strictly growing prefix
        seen = snap
        for s, tok, fin in evs:
            if fin:
                final = bat.take_result(s)
    assert final == _solo(params, prompt)
    assert final[:len(seen)] == seen[:len(final)]

def test_steps_per_tick_matches_per_step():
    """steps_per_tick=K: one step_tick() dispatch must report the SAME
    (slot, token, finished) stream K sequential step() calls do — with a
    mid-run join landing on a tick boundary and a slot finishing mid-tick
    (it parks, masked, until the tick ends)."""
    params = _params()
    rng = np.random.default_rng(4)
    prompts = [list(rng.integers(0, CFG.vocab_size, size=n)) for n in (3, 9, 6)]
    want = [_solo(params, p) for p in prompts]

    bat = ContinuousLlmBatcher(params, CFG, DC, n_slots=3, t_max=64,
                               steps_per_tick=4)
    slots, got = {}, [None] * 3
    for r in (0, 1):
        slots[bat.try_submit(_embeds(params, prompts[r])[0], len(prompts[r]))] = r
    # one tick (4 substeps), then request 2 joins on the boundary
    events = bat.step_tick()
    assert len(events) >= 2  # both slots reported every substep they ran
    for slot, tok, fin in events:
        if fin and slot in slots:
            got[slots[slot]] = bat.take_result(slot)
            del slots[slot]
    slots[bat.try_submit(_embeds(params, prompts[2])[0], len(prompts[2]))] = 2
    for _ in range(DC.max_new_tokens + 2):
        events = bat.step_tick()
        if not events:
            break
        for slot, tok, fin in events:
            if fin and slot in slots:
                got[slots[slot]] = bat.take_result(slot)
                del slots[slot]
    for r in range(3):
        assert got[r] == want[r], (r, got[r], want[r])


def test_steps_per_tick_event_stream_identical():
    """The flattened event stream (substep order) equals the per-step
    stream for the same joins — not just the final ids."""
    params = _params()
    prompt = [5, 21, 33, 2, 70, 18]

    def run(k):
        bat = ContinuousLlmBatcher(params, CFG, DC, n_slots=2, t_max=64,
                                   steps_per_tick=k)
        bat.try_submit(_embeds(params, prompt)[0], len(prompt))
        stream = []
        for _ in range(DC.max_new_tokens + 2):
            evs = bat.step_tick()
            if not evs:
                break
            stream.extend(evs)
        return stream

    assert run(4) == run(1)


def test_tensor_parallel_batcher_identity():
    """mesh with a model axis (tp=2 over the virtual devices): Megatron
    weight shards + head-sharded KV through the SAME jitted step must
    produce identical ids to the unsharded batcher — including a mid-run
    join and slot reuse."""
    from asr_jax.parallel import mesh as pmesh

    params = _params()
    rng = np.random.default_rng(11)
    prompts = [list(rng.integers(0, CFG.vocab_size, size=n)) for n in (4, 7, 5)]

    def run(mesh):
        bat = ContinuousLlmBatcher(params, CFG, DC, n_slots=2, t_max=64,
                                   mesh=mesh)
        emb = lambda p: params["embed"][jnp.asarray([p], jnp.int32)][0]
        slots = {bat.try_submit(emb(p), len(p)): r
                 for r, p in enumerate(prompts[:2])}
        got, joined = [None] * 3, False
        for _ in range(3 * (DC.max_new_tokens + 2)):
            evs = bat.step()
            if not evs and joined:
                break
            for s, tok, fin in evs:
                if fin:
                    got[slots.pop(s)] = bat.take_result(s)
            if not joined and got[0] is not None:  # reuse the freed slot
                slots[bat.try_submit(emb(prompts[2]), len(prompts[2]))] = 2
                joined = True
        return got

    base = run(None)
    tp = run(pmesh.make_mesh(2, model_parallel=2))
    assert base == tp, (base, tp)


def test_tensor_parallel_requires_divisible_heads():
    from asr_jax.parallel import mesh as pmesh
    import pytest

    with pytest.raises(ValueError, match="divide"):
        ContinuousLlmBatcher(_params(), CFG, DC, n_slots=2, t_max=64,
                             mesh=pmesh.make_mesh(8, model_parallel=8))


def test_tensor_parallel_composes_with_steps_per_tick():
    """tp=2 AND steps_per_tick=3 (the scan-fused step under GSPMD): same
    ids as the plain unsharded per-step engine."""
    from asr_jax.parallel import mesh as pmesh

    params = _params()
    prompt = [3, 50, 12, 77, 8]

    def run(mesh, k):
        bat = ContinuousLlmBatcher(params, CFG, DC, n_slots=2, t_max=64,
                                   mesh=mesh, steps_per_tick=k)
        bat.try_submit(params["embed"][jnp.asarray([prompt], jnp.int32)][0],
                       len(prompt))
        stream = []
        for _ in range(DC.max_new_tokens + 2):
            evs = bat.step_tick()
            if not evs:
                break
            stream.extend(evs)
        return stream

    assert run(pmesh.make_mesh(2, model_parallel=2), 3) == run(None, 1)


def test_steps_per_tick_sampling_key_state_matches_per_step():
    """Sampling + steps_per_tick: trailing all-inactive substeps of a tick
    must NOT advance PRNG state — a request joining a freed slot after an
    idle tick tail samples the same stream as under steps_per_tick=1."""
    params = _params()
    dc = DecodeConfig(max_new_tokens=2, eot_id=EOT, strategy="sampling",
                      temperature=0.9, top_k=12)
    rng = np.random.default_rng(21)
    p1 = list(rng.integers(0, CFG.vocab_size, size=4))
    p2 = list(rng.integers(0, CFG.vocab_size, size=6))

    def run(k):
        bat = ContinuousLlmBatcher(params, CFG, dc, n_slots=2, t_max=64,
                                   steps_per_tick=k,
                                   rng=jax.random.PRNGKey(3))
        emb = lambda p: _embeds(params, p)[0]
        out = []
        s1 = bat.try_submit(emb(p1), len(p1))
        # drain: with max_new_tokens=2 the request dies mid-tick at k=4,
        # leaving trailing inactive substeps
        for _ in range(dc.max_new_tokens + 2):
            for s, tok, fin in bat.step_tick():
                if fin:
                    out.append(bat.take_result(s))
            if not bat.n_active:
                break
        # second request reuses the slot; its sample stream depends on the
        # slot's key state
        s2 = bat.try_submit(emb(p2), len(p2))
        for _ in range(dc.max_new_tokens + 2):
            for s, tok, fin in bat.step_tick():
                if fin:
                    out.append(bat.take_result(s))
            if not bat.n_active:
                break
        return out

    assert run(4) == run(1)


def test_sampling_seed_determinism():
    """Sampled tokens depend only on (request seed, own step index): the
    slot PRNG stream reseeds from fold_in(base_key, seed) at insert, so
    engine history and sibling slots cannot perturb a request's sample."""
    dc = DecodeConfig(max_new_tokens=8, eot_id=EOT, strategy="sampling",
                      temperature=1.0, top_k=8, top_p=1.0)
    params = _params()
    ids = [3, 11, 42]

    def run(prewarm):
        bat = ContinuousLlmBatcher(params, CFG, dc, n_slots=2, t_max=64)
        if prewarm:
            bat.try_submit(_embeds(params, [9, 1]), 2, seed=999)
            bat.step()
            bat.step()
        slot = bat.try_submit(_embeds(params, ids), len(ids), seed=42)
        for _ in range(dc.max_new_tokens + 2):
            if not bat.is_active(slot):
                break
            bat.step()
        return bat.take_result(slot)

    assert run(False) == run(True)
