"""Continuous AED batching: per-slot output must be token-identical to the
proven solo paths (``models/whisper.transcribe_window`` /
``models/firered.transcribe`` / ``models/dolphin.transcribe``) even when
requests join mid-flight of other requests' decodes; the rowwise AED step
matches ``layers/transformer.decoder_block`` numerically; slots free and
reuse; step_tick fuses K steps with an identical token stream."""

import numpy as np
import jax
import jax.numpy as jnp

from asr_jax.decode.ar import DecodeConfig
from asr_jax.models import whisper as wh
from asr_jax.parallel.aed_batcher import (
    AedEngineSpec,
    ContinuousAedBatcher,
    aed_decoder_step_rowwise,
    spec_for_aed,
    spec_for_whisper,
)

WCFG = wh.WhisperConfig(
    vocab_size=96, d_model=32, encoder_layers=1, decoder_layers=2,
    num_heads=4, n_mels=16, ffn_dim=48, max_source_positions=40,
    max_target_positions=24, sot_id=1, eot_id=2, first_language_id=10,
    num_languages=4, no_speech_id=30, no_timestamps_id=5, transcribe_id=6,
    translate_id=7,
)
WDC = DecodeConfig(max_new_tokens=6, eot_id=WCFG.eot_id,
                   suppress_ids=(3, 4), strategy="greedy")
BEGIN_SUPPRESS = (8, 9)
WINDOW = 12800  # 0.8 s -> 80 mel frames -> enc 40 == max_source_positions


def _wparams():
    return wh.init_params(WCFG, jax.random.PRNGKey(0))


def _audio(seed):
    return (np.random.default_rng(seed).standard_normal(WINDOW) * 0.05
            ).astype(np.float32)


def _prompt():
    return jnp.asarray([[WCFG.sot_id, -1, WCFG.transcribe_id,
                         WCFG.no_timestamps_id]], jnp.int32)


def _solo_whisper(params, audio, dc=WDC):
    mel = wh.mel_for_audio(WCFG, jnp.asarray(audio)[None])
    out = wh.transcribe_window(params, WCFG, mel, _prompt(), dc,
                               begin_suppress_ids=BEGIN_SUPPRESS)
    c = int(out["counts"][0])
    return [int(t) for t in np.asarray(out["tokens"])[0, 4:4 + c]]


def _submit_whisper(bat, params, audio, dc=WDC):
    mel = wh.mel_for_audio(WCFG, jnp.asarray(audio)[None])
    pre = wh.prefill_window(params, WCFG, mel, _prompt(), dc,
                            begin_suppress_ids=BEGIN_SUPPRESS)
    tc = pre["state"]["layers"][0]["cross_k"].shape[1]
    return bat.try_submit(pre["state"], 4, pre["logits0"], tc)


def _drain(bat, slots, got, max_steps=None):
    for _ in range(max_steps or (WDC.max_new_tokens + 2)):
        events = bat.step_tick()
        if not events:
            break
        for slot, _tok, fin in events:
            if fin and slot in slots:
                got[slots[slot]] = bat.take_result(slot)
                del slots[slot]
    return got


def test_rowwise_step_matches_decoder_block():
    """One rowwise AED step (equal positions, full tc_valid) == one solo
    decoder_block step."""
    params = _wparams()
    mel = wh.mel_for_audio(WCFG, jnp.asarray(np.stack([_audio(1), _audio(2)])))
    enc = wh.encode(params, WCFG, mel)
    state = wh.make_state(params, WCFG, enc)
    prompt = jnp.tile(_prompt(), (2, 1))
    _, state = wh.prefill(params, WCFG, state, prompt)

    tok = jnp.asarray([[11], [17]], jnp.int32)
    ref_logits, ref_state = wh.step(params, WCFG, state, tok,
                                    jnp.asarray(4, jnp.int32))

    from asr_jax.parallel.aed_batcher import _embed_rows
    spec = spec_for_whisper(WCFG)
    x = _embed_rows(params["decoder"], spec, tok[:, 0],
                    jnp.asarray([4, 4], jnp.int32))
    tc = enc.shape[1]
    hidden, row_state = aed_decoder_step_rowwise(
        params["decoder"], spec, x[:, None], state,
        jnp.asarray([4, 4], jnp.int32), jnp.asarray([tc, tc], jnp.int32),
        jnp.asarray([True, True]))
    from asr_jax.quant.quantize import embedding_logits
    row_logits = embedding_logits(params["decoder"]["embed"], hidden[:, -1])
    np.testing.assert_allclose(np.asarray(row_logits), np.asarray(ref_logits),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(row_state["layers"], ref_state["layers"]):
        np.testing.assert_allclose(np.asarray(a["self_k"]),
                                   np.asarray(b["self_k"]), rtol=1e-5,
                                   atol=1e-6)


def test_rowwise_inactive_rows_untouched():
    params = _wparams()
    mel = wh.mel_for_audio(WCFG, jnp.asarray(np.stack([_audio(1), _audio(2)])))
    enc = wh.encode(params, WCFG, mel)
    state = wh.make_state(params, WCFG, enc)
    marker = state["layers"][0]["self_k"].at[1].set(3.25)
    state["layers"] = (dict(state["layers"][0], self_k=marker),) + state["layers"][1:]
    spec = spec_for_whisper(WCFG)
    from asr_jax.parallel.aed_batcher import _embed_rows
    x = _embed_rows(params["decoder"], spec, jnp.asarray([4, 4], jnp.int32),
                    jnp.asarray([0, 5], jnp.int32))
    _, st = aed_decoder_step_rowwise(
        params["decoder"], spec, x[:, None], state,
        jnp.asarray([0, 5], jnp.int32),
        jnp.asarray([enc.shape[1]] * 2, jnp.int32),
        jnp.asarray([True, False]))
    k = np.asarray(st["layers"][0]["self_k"])
    assert (k[1] == 3.25).all()          # parked row wrote nowhere
    assert (k[0, 0] != 0).any()          # active row wrote slot 0


def test_whisper_continuous_matches_solo_staggered_joins():
    params = _wparams()
    audios = [_audio(s) for s in range(5)]
    want = [_solo_whisper(params, a) for a in audios]

    bat = ContinuousAedBatcher(params, spec_for_whisper(WCFG), WDC, n_slots=3)
    slots = {}
    got = [None] * len(audios)
    for r in (0, 1):
        s = _submit_whisper(bat, params, audios[r])
        assert s is not None
        slots[s] = r
    for _ in range(2):  # two steps mid-flight, then request 2 JOINS
        for slot, _tok, fin in bat.step():
            if fin:
                got[slots[slot]] = bat.take_result(slot)
                del slots[slot]
    s = _submit_whisper(bat, params, audios[2])
    assert s is not None
    slots[s] = 2
    got = _drain(bat, slots, got)
    for r in (3, 4):  # late requests after the batch drained: slot reuse
        s = _submit_whisper(bat, params, audios[r])
        slots[s] = r
    got = _drain(bat, slots, got)

    for r, (g, w) in enumerate(zip(got, want)):
        assert g == w, (r, g, w)


def test_whisper_penalty_strategy_identity():
    dc = DecodeConfig(max_new_tokens=6, eot_id=WCFG.eot_id,
                      strategy="penalty", penalty=1.5, penalty_range=4)
    params = _wparams()
    audios = [_audio(s) for s in (7, 8)]
    want = [_solo_whisper(params, a, dc) for a in audios]
    bat = ContinuousAedBatcher(params, spec_for_whisper(WCFG), dc, n_slots=2)
    slots = {}
    got = [None] * 2
    for r in (0, 1):
        slots[_submit_whisper(bat, params, audios[r], dc)] = r
    for _ in range(dc.max_new_tokens + 2):
        events = bat.step()
        if not events:
            break
        for slot, _tok, fin in events:
            if fin and slot in slots:
                got[slots[slot]] = bat.take_result(slot)
                del slots[slot]
    assert got == want


def test_steps_per_tick_identical_stream():
    params = _wparams()
    audios = [_audio(s) for s in (11, 12, 13)]

    def run(k):
        bat = ContinuousAedBatcher(params, spec_for_whisper(WCFG), WDC,
                                   n_slots=3, steps_per_tick=k)
        slots = {}
        got = [None] * len(audios)
        for r, a in enumerate(audios):
            slots[_submit_whisper(bat, params, a)] = r
        return _drain(bat, slots, got, max_steps=WDC.max_new_tokens + 2)

    assert run(1) == run(3)


def test_slot_exhaustion_and_no_speech_cap():
    params = _wparams()
    bat = ContinuousAedBatcher(params, spec_for_whisper(WCFG), WDC, n_slots=1)
    s0 = _submit_whisper(bat, params, _audio(20))
    assert s0 is not None
    assert _submit_whisper(bat, params, _audio(21)) is None  # full
    while bat.is_active(s0):
        bat.step()
    bat.take_result(s0)
    assert _submit_whisper(bat, params, _audio(21)) is not None  # freed


def test_firered_continuous_matches_solo():
    from asr_jax.models import firered as fr

    cfg = fr.FireRedConfig(vocab_size=60, d_model=32, enc_layers=1,
                           enc_heads=4, conv_kernel=9, dec_layers=2,
                           dec_heads=4, dec_ffn=48, max_target_positions=16)
    dc = DecodeConfig(max_new_tokens=5, eot_id=cfg.eos_id)
    params = fr.init_params(cfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    audios = [(rng.standard_normal(8000) * 2000).astype(np.float32)
              for _ in range(3)]

    def solo(a):
        toks, counts = fr.transcribe(params, cfg, jnp.asarray(a)[None],
                                     jnp.asarray([len(a)], jnp.int32), dc)
        return [int(t) for t in np.asarray(toks)[0, 1:1 + int(counts[0])]]

    want = [solo(a) for a in audios]
    pre0 = fr.prefill_window(params, cfg, jnp.asarray(audios[0])[None],
                             jnp.asarray([len(audios[0])], jnp.int32), dc)
    tc = pre0["state"]["layers"][0]["cross_k"].shape[1]
    bat = ContinuousAedBatcher(params, spec_for_aed(cfg, tc), dc, n_slots=2)
    slots, got = {}, [None] * 3

    def submit(r):
        pre = fr.prefill_window(params, cfg, jnp.asarray(audios[r])[None],
                                jnp.asarray([len(audios[r])], jnp.int32), dc)
        slots[bat.try_submit(pre["state"], 1, pre["logits0"],
                             int(pre["enc_valid"][0]))] = r

    submit(0)
    bat.step()
    submit(1)  # joins mid-flight
    for _ in range(dc.max_new_tokens + 2):
        events = bat.step()
        if not events:
            break
        for slot, _tok, fin in events:
            if fin and slot in slots:
                got[slots[slot]] = bat.take_result(slot)
                del slots[slot]
    submit(2)
    for _ in range(dc.max_new_tokens + 2):
        events = bat.step()
        if not events:
            break
        for slot, _tok, fin in events:
            if fin and slot in slots:
                got[slots[slot]] = bat.take_result(slot)
                del slots[slot]
    assert got == want


def test_dolphin_continuous_matches_solo_with_probes():
    from asr_jax.models import dolphin as dp

    cfg = dp.DolphinConfig(vocab_size=60, d_model=32, enc_layers=1,
                           enc_heads=4, enc_ffn=48, cgmlp_dim=48,
                           csgu_kernel=5, fusion_kernel=3, dec_layers=2,
                           dec_heads=4, dec_ffn=48, sos_id=50, eos_id=51,
                           max_target_positions=16,
                           language_token_start=40, language_token_end=45,
                           region_token_start=45, region_token_end=49)
    dc = DecodeConfig(max_new_tokens=5, eot_id=cfg.eos_id)
    params = dp.init_params(cfg, jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)
    audios = [(rng.standard_normal(8000) * 2000).astype(np.float32)
              for _ in range(2)]
    prompt = jnp.asarray([[cfg.sos_id, -1, -2]], jnp.int32)

    def solo(a):
        out = dp.transcribe(params, cfg, jnp.asarray(a)[None],
                            jnp.asarray([len(a)], jnp.int32), prompt, dc)
        c = int(out["counts"][0])
        return [int(t) for t in np.asarray(out["tokens"])[0, 3:3 + c]]

    want = [solo(a) for a in audios]
    pre0 = dp.prefill_window(params, cfg, jnp.asarray(audios[0])[None],
                             jnp.asarray([len(audios[0])], jnp.int32),
                             prompt, dc)
    tc = pre0["state"]["layers"][0]["cross_k"].shape[1]
    bat = ContinuousAedBatcher(params, spec_for_aed(cfg, tc), dc, n_slots=2)
    slots, got = {}, [None] * 2
    for r, a in enumerate(audios):
        pre = dp.prefill_window(params, cfg, jnp.asarray(a)[None],
                                jnp.asarray([len(a)], jnp.int32), prompt, dc)
        slots[bat.try_submit(pre["state"], 3, pre["logits0"],
                             int(pre["enc_valid"][0]))] = r
    for _ in range(dc.max_new_tokens + 2):
        events = bat.step()
        if not events:
            break
        for slot, _tok, fin in events:
            if fin and slot in slots:
                got[slots[slot]] = bat.take_result(slot)
                del slots[slot]
    assert got == want


def test_sampling_seed_determinism():
    """Sampled tokens are a deterministic function of (request seed, own
    step index) — independent of engine history and sibling slots (the
    slot's PRNG stream reseeds from fold_in(base_key, seed) at insert)."""
    dc = DecodeConfig(max_new_tokens=6, eot_id=WCFG.eot_id,
                      strategy="sampling", temperature=1.0, top_k=8,
                      top_p=1.0)
    params = _wparams()
    audio = _audio(31)

    def submit(bat, aud, seed):
        mel = wh.mel_for_audio(WCFG, jnp.asarray(aud)[None])
        pre = wh.prefill_window(params, WCFG, mel, _prompt(), dc,
                                begin_suppress_ids=BEGIN_SUPPRESS)
        tc = pre["state"]["layers"][0]["cross_k"].shape[1]
        return bat.try_submit(pre["state"], 4, pre["logits0"], tc, seed=seed)

    def run(prewarm):
        bat = ContinuousAedBatcher(params, spec_for_whisper(WCFG), dc,
                                   n_slots=2)
        if prewarm:  # different engine history + a live sibling slot
            submit(bat, _audio(32), seed=999)
            bat.step()
            bat.step()
        slot = submit(bat, audio, seed=42)
        for _ in range(dc.max_new_tokens + 2):
            if not bat.is_active(slot):
                break
            bat.step()
        return bat.take_result(slot)

    assert run(False) == run(True)
