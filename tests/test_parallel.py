"""Parallelism: 8-virtual-device mesh, dp/tp sharded forward + train step."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from asr_jax.models import sensevoice as sv
from asr_jax.parallel import mesh as pmesh
from asr_jax.parallel import train

TINY = sv.SenseVoiceConfig(
    vocab_size=64, hidden=32, num_heads=4, head_dim=8, ffn_dim=64,
    num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5,
)


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_dp_forward_matches_single_device():
    mesh = pmesh.make_mesh(8, model_parallel=1)
    params = sv.init_params(TINY, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((8, 4800)) * 2000).astype(np.float32)
    valid = np.full((8,), 4800, np.int32)
    lang = np.zeros((8,), np.int32)

    toks_ref, n_ref = sv.forward(params, TINY, jnp.asarray(audio), jnp.asarray(valid), jnp.asarray(lang))

    params_sh = pmesh.shard_params(params, mesh)
    audio_sh = jax.device_put(jnp.asarray(audio), pmesh.batch_sharded(mesh))
    valid_sh = jax.device_put(jnp.asarray(valid), pmesh.batch_sharded(mesh))
    lang_sh = jax.device_put(jnp.asarray(lang), pmesh.batch_sharded(mesh))
    toks_dp, n_dp = sv.forward(params_sh, TINY, audio_sh, valid_sh, lang_sh)

    np.testing.assert_array_equal(np.asarray(n_ref), np.asarray(n_dp))
    np.testing.assert_array_equal(np.asarray(toks_ref), np.asarray(toks_dp))


def test_tp_train_step_runs_and_matches_unsharded_loss():
    mesh = pmesh.make_mesh(8, model_parallel=2)
    params = sv.init_params(TINY, jax.random.PRNGKey(1))
    specs = pmesh.sensevoice_param_specs(params)
    params_sh = pmesh.shard_params(params, mesh, specs)

    optimizer = train.make_optimizer()
    opt_state = optimizer.init(params_sh)
    opt_state_ref = optimizer.init(params)

    rng = np.random.default_rng(1)
    batch = 4
    audio = jnp.asarray((rng.standard_normal((batch, 4800)) * 2000).astype(np.float32))
    valid = jnp.full((batch,), 4800, jnp.int32)
    lang = jnp.zeros((batch,), jnp.int32)
    labels = jnp.asarray(rng.integers(1, TINY.vocab_size, (batch, 6), dtype=np.int32))
    lv = jnp.full((batch,), 6, jnp.int32)

    audio_sh = jax.device_put(audio, pmesh.batch_sharded(mesh))
    _, _, loss_sh = train.train_step(
        params_sh, opt_state, TINY, optimizer, audio_sh, valid, lang, labels, lv
    )
    _, _, loss_ref = train.train_step(
        params, opt_state_ref, TINY, optimizer, audio, valid, lang, labels, lv
    )
    np.testing.assert_allclose(float(loss_sh), float(loss_ref), rtol=1e-4)


def test_graft_entry_dryrun_multichip():
    import importlib.util

    spec = importlib.util.spec_from_file_location("graft_entry", "/root/repo/__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)


def test_data_parallel_runner_pads_and_matches():
    from asr_jax.parallel.serve import DataParallelRunner

    runner = DataParallelRunner(pmesh.make_mesh(8, model_parallel=1))
    params = sv.init_params(TINY, jax.random.PRNGKey(5))
    params_sh = runner.shard_params(params)
    rng = np.random.default_rng(5)
    audio = (rng.standard_normal((5, 4800)) * 2000).astype(np.float32)  # 5 % 8 != 0
    valid = np.full((5,), 4800, np.int32)
    lang = np.zeros((5,), np.int32)

    def fn(p, a, v, l):
        return sv.forward(p, TINY, a, v, l)

    toks, counts = runner(fn, params_sh, audio, valid, lang)
    ref_t, ref_n = sv.forward(params, TINY, jnp.asarray(audio), jnp.asarray(valid), jnp.asarray(lang))
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(ref_n))
    np.testing.assert_array_equal(np.asarray(toks), np.asarray(ref_t))


def test_train_checkpoint_roundtrip(tmp_path):
    from asr_jax.parallel import checkpoint as ckpt
    from asr_jax.parallel import train

    params = sv.init_params(TINY, jax.random.PRNGKey(6))
    optimizer = train.make_optimizer()
    opt_state = optimizer.init(params)
    ckpt.save_train_state(tmp_path / "ck", params, opt_state, step=7)
    assert ckpt.latest_step(tmp_path / "ck") == 7
    template = {"params": params, "opt_state": opt_state, "step": jnp.asarray(7)}
    p2, o2, s2 = ckpt.restore_train_state(tmp_path / "ck", template)
    assert s2 == 7
    np.testing.assert_array_equal(
        np.asarray(p2["ctc"]["w"]), np.asarray(params["ctc"]["w"])
    )


def test_micro_batcher_matches_individual_calls():
    """Concurrent submits coalesce into fixed-shape batches; per-request
    results equal a direct per-sample forward."""
    import jax.numpy as jnp
    from asr_jax.models import paraformer as pf
    from asr_jax.parallel.server import MicroBatcher

    cfg = pf.ParaformerConfig(
        vocab_size=50, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
        num_encoders0=1, num_encoders=1, num_decoders=1, num_decoder_ffn=1,
        fsmn_kernel=5, predictor_kernel=3,
    )
    params = pf.init_params(cfg, jax.random.PRNGKey(0))
    window = 8000

    def batch_fn(audio, valid):
        toks, counts = pf.forward(params, cfg, jnp.asarray(audio), jnp.asarray(valid), max_tokens=16)
        return {"tokens": toks, "counts": counts}

    mb = MicroBatcher(batch_fn, window_samples=window, max_batch=4, max_wait_ms=30.0)
    rng = np.random.default_rng(0)
    audios = [(rng.standard_normal(window - 100 * i) * 2000).astype(np.float32) for i in range(5)]
    futures = [mb.submit(a) for a in audios]
    results = [f.result(timeout=120) for f in futures]
    mb.close()
    assert mb.requests_served == 5
    # 5 requests with max_batch 4 -> at least 2 dispatches
    assert mb.batches_dispatched >= 2

    for a, res in zip(audios, results):
        buf = np.zeros((1, window), np.float32)
        buf[0, : len(a)] = a
        toks, counts = pf.forward(params, cfg, jnp.asarray(buf), jnp.asarray([len(a)]), max_tokens=16)
        n = int(counts[0])
        assert int(res["counts"]) == n
        np.testing.assert_array_equal(res["tokens"][:n], np.asarray(toks)[0, :n])


def test_micro_batcher_error_propagation_and_close():
    from asr_jax.parallel.server import MicroBatcher

    def bad_fn(audio, valid):
        raise RuntimeError("boom")

    mb = MicroBatcher(bad_fn, window_samples=100, max_batch=2, max_wait_ms=1.0)
    fut = mb.submit(np.zeros(50, np.float32))
    with pytest.raises(RuntimeError, match="boom"):
        fut.result(timeout=30)
    mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(np.zeros(10, np.float32))
    with pytest.raises(ValueError):
        MicroBatcher(bad_fn, window_samples=10, max_batch=1).submit(np.zeros(11, np.float32))


def test_fit_with_checkpoint_resume(tmp_path):
    from asr_jax.parallel import train

    cfg = TINY
    params = sv.init_params(cfg, jax.random.PRNGKey(0))
    optimizer = train.make_optimizer(lr=1e-3)
    rng = np.random.default_rng(0)

    def batches():
        r = np.random.default_rng(42)  # deterministic -> resume replays
        while True:
            audio = jnp.asarray((r.standard_normal((2, 4800)) * 2000).astype(np.float32))
            yield (cfg, optimizer, audio, jnp.asarray([4800, 4800]),
                   jnp.zeros((2,), jnp.int32),
                   jnp.asarray(r.integers(1, cfg.vocab_size, (2, 6)), jnp.int32),
                   jnp.asarray([6, 6]))

    def step_fn(params, opt_state, optimizer, cfg, _opt, *batch):
        return train.train_step(params, opt_state, cfg, optimizer, *batch)

    ck = str(tmp_path / "ck")
    logs = []
    p1, _, losses1 = train.fit(step_fn, params, optimizer, batches(), num_steps=4,
                               ckpt_dir=ck, ckpt_every=2, log_every=2,
                               log_fn=logs.append)
    assert len(losses1) == 4 and any("step 2/4" in l for l in logs)
    from asr_jax.parallel.checkpoint import latest_step
    assert latest_step(ck) == 4

    # resume: same fresh init, fit to 6 -> continues from 4, runs 2 more
    logs2 = []
    p2, _, losses2 = train.fit(step_fn, sv.init_params(cfg, jax.random.PRNGKey(0)),
                               optimizer, batches(), num_steps=6,
                               ckpt_dir=ck, ckpt_every=10, log_every=0,
                               log_fn=logs2.append)
    assert any("resumed from step 4" in l for l in logs2)
    assert len(losses2) == 2
    assert latest_step(ck) == 6


def test_whisper_session_identical_one_vs_eight_devices():
    """VERDICT r1 item 5: WhisperSession transcription must be identical
    when run single-device vs sharded over an 8-virtual-device data mesh."""
    from asr_jax.models import whisper as wh
    from asr_jax.runtime.whisper_session import WhisperSession, WhisperSessionConfig

    cfg = wh.WhisperConfig(
        vocab_size=96, d_model=32, encoder_layers=1, decoder_layers=1,
        num_heads=4, n_mels=16, max_source_positions=40,
        max_target_positions=24, sot_id=1, eot_id=2, first_language_id=10,
        num_languages=4, transcribe_id=20, translate_id=21,
        no_timestamps_id=22, no_speech_id=30,
    )
    params = wh.init_params(cfg, jax.random.PRNGKey(4))
    scfg = WhisperSessionConfig(max_new_tokens=6, no_speech_threshold=None)
    rng = np.random.default_rng(0)
    # window sized to the tiny pos table (40 positions = 0.8 s);
    # ~2.3 windows of audio -> 3 real windows, bucketed to 4, padded to 8 by DP.
    ws = 0.8
    audio = (rng.standard_normal(int(2.3 * ws * cfg.sample_rate)) * 0.05).astype(np.float32)

    single = WhisperSession(params, cfg, session_cfg=scfg, window_seconds=ws)
    res1 = single.transcribe(audio)

    mesh = pmesh.make_mesh(8, model_parallel=1)
    sharded = WhisperSession(params, cfg, session_cfg=scfg, mesh=mesh, window_seconds=ws)
    res8 = sharded.transcribe(audio)
    assert res8.token_ids == res1.token_ids


def test_windowed_session_mesh_matches_single():
    """_WindowedSession families accept mesh= and produce identical ids."""
    from asr_jax.models import parakeet as pk
    from asr_jax.runtime.transducer_session import ParakeetSession
    from asr_jax.frontend.nemo_mel import NemoMelConfig

    cfg = pk.ParakeetConfig(
        vocab_size=40, blank_id=39, d_model=64, num_layers=1, num_heads=4,
        ffn_dim=96, conv_kernel=9, sub_channels=16, dec_hidden=32,
        mel=NemoMelConfig(n_mels=80),
    )
    params = pk.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal(16000) * 0.05).astype(np.float32)

    res1 = ParakeetSession(params, cfg, window_seconds=0.4).transcribe(audio)
    mesh = pmesh.make_mesh(8, model_parallel=1)
    res8 = ParakeetSession(params, cfg, window_seconds=0.4, mesh=mesh).transcribe(audio)
    assert res8.token_ids == res1.token_ids


def test_whisper_tp_specs_forward_matches_replicated():
    """Whisper TP PartitionSpecs: a (2 data, 4 model) mesh forward equals
    the unsharded forward (heads=4 divide the model axis)."""
    from asr_jax.models import whisper as wh

    cfg = wh.WhisperConfig(
        vocab_size=96, d_model=32, encoder_layers=1, decoder_layers=1,
        num_heads=4, n_mels=16, max_source_positions=40,
        max_target_positions=24, sot_id=1, eot_id=2, first_language_id=10,
        num_languages=4, transcribe_id=20, translate_id=21,
        no_timestamps_id=22, no_speech_id=30,
    )
    params = wh.init_params(cfg, jax.random.PRNGKey(7))
    mel = jnp.asarray(np.random.default_rng(2).standard_normal((2, 20, 16)).astype(np.float32))
    ref = np.asarray(wh.encode(params, cfg, mel))

    mesh = pmesh.make_mesh(8, model_parallel=4)
    specs = pmesh.whisper_param_specs(params)
    sharded = pmesh.shard_params(params, mesh, specs)
    out = np.asarray(wh.encode(sharded, cfg, mel))
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


def test_qwen3_tp_specs_forward_matches_replicated():
    """Qwen3 TP specs: kv heads (2) divide the model axis (2)."""
    from asr_jax.layers import qwen3

    cfg = qwen3.Qwen3Config(
        vocab_size=64, hidden=32, num_layers=2, num_heads=4, num_kv_heads=2,
        head_dim=8, ffn_dim=48,
    )
    params = qwen3.init_params(cfg, jax.random.PRNGKey(3))
    ids = jnp.asarray(np.random.default_rng(5).integers(0, 64, (1, 6)))
    embeds = params["embed"][ids]
    t_max = 12

    def run(p):
        state = qwen3.make_kv_state(cfg, 1, t_max)
        bias = qwen3.causal_prefill_bias(jnp.asarray([6]), 6, t_max)
        hidden, _ = qwen3.decoder_pass(p, cfg, embeds, state, jnp.asarray(0, jnp.int32), bias)
        return np.asarray(qwen3.logits_from_hidden(p, cfg, hidden))

    ref = run(params)
    mesh = pmesh.make_mesh(8, model_parallel=2)
    sharded = pmesh.shard_params(params, mesh, pmesh.qwen3_param_specs(params))
    np.testing.assert_allclose(run(sharded), ref, rtol=2e-5, atol=2e-5)


def test_whisper_aed_train_step_dp_tp():
    """Teacher-forced AED fine-tuning: loss decreases over steps on a fixed
    batch, and the dp x tp sharded step matches the unsharded loss."""
    from asr_jax.models import whisper as wh

    cfg = wh.WhisperConfig(
        vocab_size=96, d_model=32, encoder_layers=1, decoder_layers=1,
        num_heads=4, n_mels=16, max_source_positions=20,
        max_target_positions=16, sot_id=1, eot_id=2, first_language_id=10,
        num_languages=4, transcribe_id=20, translate_id=21,
        no_timestamps_id=22, no_speech_id=30,
    )
    params = wh.init_params(cfg, jax.random.PRNGKey(0))
    optimizer = train.make_optimizer(lr=1e-3)
    opt_state = optimizer.init(params)
    rng = np.random.default_rng(0)
    mel = jnp.asarray(rng.standard_normal((4, 40, 16)).astype(np.float32) * 0.3)
    tokens = jnp.asarray(rng.integers(3, 96, (4, 10), dtype=np.int32))
    tok_valid = jnp.asarray([10, 8, 10, 6], np.int32)

    p, o = params, opt_state
    losses = []
    for _ in range(4):
        p, o, loss = train.whisper_train_step(p, o, cfg, optimizer, mel, tokens, tok_valid)
        losses.append(float(loss))
    assert losses[-1] < losses[0]

    # dp x tp sharded step reproduces the unsharded first-step loss.
    mesh = pmesh.make_mesh(8, model_parallel=2)
    sp = pmesh.shard_params(params, mesh, pmesh.whisper_param_specs(params))
    so = jax.device_put(opt_state, pmesh.replicated(mesh))
    smel = jax.device_put(mel, pmesh.batch_sharded(mesh))
    stok = jax.device_put(tokens, pmesh.batch_sharded(mesh))
    sval = jax.device_put(tok_valid, pmesh.batch_sharded(mesh))
    _, _, sloss = train.whisper_train_step(sp, so, cfg, optimizer, smel, stok, sval)
    np.testing.assert_allclose(float(sloss), losses[0], rtol=2e-5, atol=2e-5)


def test_sensevoice_transcribe_batch_uses_runner(tmp_path):
    """transcribe_batch must route through the DataParallelRunner when a
    mesh is configured (regression: --data-parallel was a silent no-op for
    exactly the multi-file batch workload it exists for) and match the
    single-device results."""
    import wave

    from asr_jax.models import sensevoice as sv
    from asr_jax.runtime.session import SenseVoiceSession

    cfg = sv.SenseVoiceConfig(
        vocab_size=64, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
        num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5,
    )
    params = sv.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    paths = []
    for i in range(3):  # 3 files: also exercises runner padding (8 devices)
        pcm = (rng.standard_normal(4000) * 2000).astype(np.int16)
        p = tmp_path / f"a{i}.wav"
        with wave.open(str(p), "wb") as w:
            w.setnchannels(1); w.setsampwidth(2); w.setframerate(16000)
            w.writeframes(pcm.tobytes())
        paths.append(str(p))

    single = SenseVoiceSession(params, cfg, window_seconds=0.3)
    mesh = pmesh.make_mesh(8, model_parallel=1)
    sharded = SenseVoiceSession(params, cfg, window_seconds=0.3, mesh=mesh)
    calls = []
    orig = sharded.runner.__call__
    sharded.runner = lambda *a, **k: (calls.append(1), orig(*a, **k))[1]
    r1 = single.transcribe_batch(paths)
    r8 = sharded.transcribe_batch(paths)
    assert calls, "transcribe_batch bypassed the DataParallelRunner"
    assert [r.token_ids for r in r8] == [r.token_ids for r in r1]


def test_qwen_session_tp_serving_matches_dp():
    """VERDICT r2 item 3: tensor parallelism as a SERVING capability —
    QwenAsrSession batched transcribe must produce identical tokens
    unsharded, dp=8/tp=1, and dp=4/tp=2 (LLM params sharded by
    qwen3_param_specs over the model axis)."""
    from asr_jax.layers import qwen3
    from asr_jax.models import qwen_asr as qa
    from asr_jax.runtime.qwen_session import QwenAsrSession, QwenPromptTemplate

    lcfg = qwen3.Qwen3Config(vocab_size=120, hidden=48, num_layers=1, num_heads=4,
                             num_kv_heads=2, head_dim=16, ffn_dim=64, rope_theta=1e4)
    cfg = qa.QwenAsrConfig(
        n_mels=16, tower_dim=32, tower_layers=1, tower_heads=4, tower_ffn=48,
        downsample_hidden=8, chunks_per_window=2, output_dim=lcfg.hidden,
        llm=lcfg, eot_id=-1,
    )
    tower = qa.init_tower_params(cfg, jax.random.PRNGKey(0))
    llm = qwen3.init_params(lcfg, jax.random.PRNGKey(1))
    tpl = QwenPromptTemplate(head_ids=(1, 2), tail_ids=(4,))
    rng = np.random.default_rng(7)
    audios = [(rng.standard_normal(6000) * 0.05).astype(np.float32)
              for _ in range(3)]

    def ids_of(sess):
        return [r.token_ids for r in sess.transcribe_batch(audios)]

    base = QwenAsrSession(tower, llm, cfg, template=tpl, max_new_tokens=4,
                          max_seconds=0.5)
    want = ids_of(base)
    dp8 = QwenAsrSession(tower, llm, cfg, template=tpl, max_new_tokens=4,
                         max_seconds=0.5,
                         mesh=pmesh.make_mesh(8, model_parallel=1))
    assert ids_of(dp8) == want
    dp4tp2 = QwenAsrSession(tower, llm, cfg, template=tpl, max_new_tokens=4,
                            max_seconds=0.5,
                            mesh=pmesh.make_mesh(8, model_parallel=2))
    assert ids_of(dp4tp2) == want


@pytest.mark.parametrize("vocab", [64, 65])
def test_sensevoice_session_tp_matches_single(vocab):
    """SenseVoiceSession with param_specs=sensevoice_param_specs on a
    (4 data, 2 model) mesh matches the unsharded transcription — the CLI
    --tensor-parallel path end-to-end at session level. An odd vocabulary
    (like the real 25055) cannot split over the model axis: the CTC head
    replicates instead."""
    from asr_jax.models import sensevoice as sv
    from asr_jax.runtime.session import SenseVoiceSession

    cfg = sv.SenseVoiceConfig(
        vocab_size=vocab, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
        num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5,
    )
    params = sv.init_params(cfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(5)
    audio = (rng.standard_normal(9000) * 2000).astype(np.float32)

    want = SenseVoiceSession(params, cfg, window_seconds=0.3).transcribe(audio)
    tp = SenseVoiceSession(
        params, cfg, window_seconds=0.3,
        mesh=pmesh.make_mesh(8, model_parallel=2),
        param_specs=pmesh.sensevoice_param_specs,
    ).transcribe(audio)
    assert tp.token_ids == want.token_ids


def test_qwen3_tp_specs_shard_quantized_weights():
    """Quantized (QuantizedLinear) weights must SHARD under the TP specs,
    not silently replicate (review r3 finding: their flattened child paths
    never matched the endswith rules): column-sharded positions shard
    q/scale/zero over the model axis and the forward still matches."""
    from jax.sharding import PartitionSpec as P

    from asr_jax.layers import qwen3
    from asr_jax.quant.quantize import QuantizedLinear, quantize_pytree

    cfg = qwen3.Qwen3Config(vocab_size=64, hidden=128, num_layers=1, num_heads=4,
                            num_kv_heads=2, head_dim=32, ffn_dim=256)
    params = quantize_pytree(qwen3.init_params(cfg, jax.random.PRNGKey(3)),
                             bits=8, block=64, min_size=0)
    specs = pmesh.qwen3_param_specs(params)
    qspec = specs["layers"][0]["attn"]["q"]["w"]
    assert isinstance(qspec, QuantizedLinear)
    assert qspec.q == P(None, "model") and qspec.scale == P(None, "model")
    # row-sharded positions replicate quantized leaves (packed row layout)
    ospec = specs["layers"][0]["attn"]["o"]["w"]
    assert ospec.q == P()

    mesh = pmesh.make_mesh(8, model_parallel=2)
    sharded = pmesh.shard_params(params, mesh, specs)
    qleaf = sharded["layers"][0]["attn"]["q"]["w"]
    assert "model" in str(qleaf.q.sharding.spec), qleaf.q.sharding

    ids = jnp.asarray(np.random.default_rng(5).integers(0, 64, (1, 6)))

    def run(p):
        embeds = p["embed"][ids]
        state = qwen3.make_kv_state(cfg, 1, 12)
        bias = qwen3.causal_prefill_bias(jnp.asarray([6]), 6, 12)
        hidden, _ = qwen3.decoder_pass(p, cfg, embeds, state, jnp.asarray(0, jnp.int32), bias)
        return np.asarray(qwen3.logits_from_hidden(p, cfg, hidden))

    np.testing.assert_allclose(run(sharded), run(params), rtol=2e-5, atol=2e-5)
