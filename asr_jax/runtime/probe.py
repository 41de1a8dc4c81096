"""Stage-activation probes for the parity harness (``asr_jax parity``).

When the BASELINE token-for-token gate finally runs against real
checkpoints (BASELINE.md), a transcript mismatch alone does not say WHERE
the drift is.  These probes snapshot the pipeline stage-by-stage for the
FIRST window of each fixture — front-end features, encoder output, and
first-decode-step logits — alongside the golden transcripts.  On compare,
the first drifting stage localizes a mismatch to front-end vs encoder vs
decode without a manual bisect.  The reference debugs the same split by
running its per-stage ONNX graphs individually and printing intermediates
(e.g. the separate encoder/decoder sessions of
``Whisper/Inference_Whisper_ONNX.py`` and the post-export self-test of
``SenseVoice/Export_SenseVoice.py:424-433``).

Snapshots are compact (shape + mean/std + the first ``head`` flattened
values) so goldens stay reviewable JSON; comparisons are rtol-based — the
parity harness forces the kernels' bit-exact f32 mode, so the only drift a
healthy run sees is cross-platform libm noise, well under the default
rtol.
"""

from __future__ import annotations

import numpy as np

# Compare (and report) stages in pipeline order: the FIRST drifting stage
# is the localization.
STAGE_ORDER = ("frontend", "encoder", "logits")


def summarize(arr, head: int = 48, spread: int = 48) -> dict:
    """Compact JSON-able snapshot of one activation tensor.

    ``head`` covers the leading values; ``spread`` samples ``spread``
    values STRIDED across the whole flattened tensor so a drift confined
    to late elements (long-audio frames, high vocab ids) cannot hide
    behind a clean head + global mean/std."""
    a = np.asarray(arr, np.float32)
    flat = a.reshape(-1)
    out = {
        "shape": [int(s) for s in a.shape],
        "mean": float(flat.mean()) if flat.size else 0.0,
        "std": float(flat.std()) if flat.size else 0.0,
        "head": [float(x) for x in flat[:head]],
    }
    if flat.size > head:
        idx = np.linspace(0, flat.size - 1, min(spread, flat.size)).astype(np.int64)
        out["spread"] = [float(x) for x in flat[idx]]
    return out


def _drift(got: dict, want: dict, rtol: float, atol: float) -> str | None:
    if list(got["shape"]) != list(want["shape"]):
        return f"shape {got['shape']} != {want['shape']}"
    scale = max(abs(want["mean"]) + want["std"], 1e-6)
    # "head" = leading values; "spread" = values strided across the whole
    # tensor (late-element drift localizes here). Old goldens without a
    # spread field still compare on head + stats.
    for field in ("head", "spread"):
        if field not in want or field not in got:
            continue
        g = np.asarray(got[field], np.float64)
        w = np.asarray(want[field], np.float64)
        n = min(len(g), len(w))
        if not np.allclose(g[:n], w[:n], rtol=rtol, atol=atol * scale):
            i = int(np.argmax(np.abs(g[:n] - w[:n])))
            return f"{field}[{i}] {g[i]:.6g} != {w[i]:.6g}"
    for k in ("mean", "std"):
        if not np.isclose(got[k], want[k], rtol=rtol, atol=atol * scale):
            return f"{k} {got[k]:.6g} != {want[k]:.6g}"
    return None


def compare_probes(got: dict | None, want: dict | None,
                   rtol: float = 2e-3, atol: float = 1e-4) -> list[str]:
    """Ordered stage comparison -> list of drift messages (empty = clean).

    Only the FIRST drifting stage is reported — downstream stages drift as
    a consequence and would bury the signal.
    """
    if not want:
        return []
    if not got:
        return ["probe missing from run (family has no probe support?)"]
    for stage in STAGE_ORDER:
        if stage not in want:
            continue
        if stage not in got:
            return [f"stage {stage!r} missing from run"]
        msg = _drift(got[stage], want[stage], rtol, atol)
        if msg is not None:
            return [f"first drift at stage {stage!r}: {msg}"]
    return []


# ── per-family capture ────────────────────────────────────────────────────


def _pad_row(samples: np.ndarray, width: int):
    """Clip to ``width`` and right-pad into a (1, width) f32 row; returns
    (row, clipped samples)."""
    samples = samples[:width]
    buf = np.zeros((1, width), np.float32)
    buf[0, : len(samples)] = samples
    return buf, samples


def _first_window(sess, audio, pcm_scale: float):
    buf, clipped = _pad_row(_load_samples(sess, audio, pcm_scale),
                            sess.window_samples)
    return buf, len(clipped)


def _probe_sensevoice(sess, audio) -> dict:
    import jax.numpy as jnp

    from asr_jax.frontend.kaldi_fbank import log_mel_fbank
    from asr_jax.models import sensevoice as sv

    buf, n = _first_window(sess, audio, sess.pcm_scale)
    cfg = sess.cfg
    fb = cfg.fbank
    mel = log_mel_fbank(jnp.asarray(buf), fb, fb.num_frames(buf.shape[-1]))
    logits, valid_seq = sv.encode_logits(
        sess.params, cfg, jnp.asarray(buf), jnp.asarray([n], np.int32),
        jnp.asarray([0], np.int32))
    t = int(np.asarray(valid_seq)[0])
    return {"frontend": summarize(mel[0, : max(t, 1)]),
            "logits": summarize(np.asarray(logits)[0, : max(t, 1)])}


def _probe_firered(sess, audio) -> dict:
    import jax.numpy as jnp

    from asr_jax.frontend.kaldi_fbank import log_mel_fbank
    from asr_jax.layers.attention import NEG_INF, length_mask
    from asr_jax.models import firered as fr

    buf, n = _first_window(sess, audio, sess.pcm_scale)
    cfg = sess.cfg
    fb = cfg.fbank
    mel = log_mel_fbank(jnp.asarray(buf), fb, fb.num_frames(buf.shape[-1]))
    enc, enc_valid = fr.encode(sess.params, cfg, jnp.asarray(buf),
                               jnp.asarray([n], np.int32))
    t = int(np.asarray(enc_valid)[0])
    cross_bias = jnp.where(length_mask(enc_valid, enc.shape[1]), 0.0,
                           NEG_INF)[:, None, None, :].astype(jnp.float32)
    state = fr.make_state(sess.params, cfg, enc)
    prompt = jnp.full((1, 1), cfg.sos_id, jnp.int32)
    logits, _ = fr._decoder_pass(sess.params, cfg, state, prompt,
                                 jnp.asarray(0, jnp.int32), cross_bias)
    return {"frontend": summarize(mel[0]),
            "encoder": summarize(np.asarray(enc)[0, : max(t, 1)]),
            "logits": summarize(np.asarray(logits)[0, -1])}


def _probe_whisper(sess, audio) -> dict:
    import jax.numpy as jnp

    from asr_jax.models import whisper as wh

    buf, _n = _first_window(sess, audio, 1.0)
    cfg = sess.cfg
    mel = wh.mel_for_audio(cfg, jnp.asarray(buf))
    enc = wh.encode(sess.params, cfg, mel)
    state = wh.make_state(sess.params, cfg, enc)
    prompt = jnp.full((1, 1), cfg.sot_id, jnp.int32)
    logits, _state = wh.prefill(sess.params, cfg, state, prompt)
    return {"frontend": summarize(mel[0]),
            "encoder": summarize(np.asarray(enc)[0]),
            "logits": summarize(np.asarray(logits)[0, -1])}


def _probe_paraformer(sess, audio) -> dict:
    import jax.numpy as jnp

    from asr_jax.models import paraformer as pf

    buf, n = _first_window(sess, audio, sess.pcm_scale)
    cfg = sess.cfg
    params = sess.params
    valid = jnp.asarray([n], np.int32)
    mel, feats, valid_lfr = pf.frontend_features(params, cfg,
                                                 jnp.asarray(buf), valid)
    enc = pf.encode(params, cfg, feats.astype(params["output"]["w"].dtype),
                    valid_lfr)
    alphas = pf.predict_alphas(params, cfg, enc, valid_lfr)
    embeds, counts = pf.cif_fire(alphas, enc, valid_lfr, 64, cfg.tail_threshold)
    logits = pf.decode_tokens(params, cfg, embeds.astype(enc.dtype), counts,
                              enc, valid_lfr)
    t = int(np.asarray(valid_lfr)[0])
    c = int(np.asarray(counts)[0])
    return {"frontend": summarize(mel[0]),
            "encoder": summarize(np.asarray(enc)[0, : max(t, 1)]),
            "logits": summarize(np.asarray(logits)[0, : max(c, 1)])}


def _probe_dolphin(sess, audio) -> dict:
    import jax.numpy as jnp

    from asr_jax.layers.attention import NEG_INF, length_mask
    from asr_jax.models import dolphin as dp

    buf, n = _first_window(sess, audio, sess.pcm_scale)
    cfg = sess.cfg
    mel = dp.log_mel(jnp.asarray(buf), cfg.mel)
    enc, enc_valid = dp.encode(sess.params, cfg, jnp.asarray(buf),
                               jnp.asarray([n], np.int32))
    t = int(np.asarray(enc_valid)[0])
    cross_bias = jnp.where(length_mask(enc_valid, enc.shape[1]), 0.0,
                           NEG_INF)[:, None, None, :].astype(jnp.float32)
    state = dp.make_state(sess.params, cfg, enc)
    prompt = jnp.full((1, 1), cfg.sos_id, jnp.int32)
    logits, _ = dp._decoder_pass(sess.params, cfg, state, prompt,
                                 jnp.asarray(0, jnp.int32), cross_bias)
    return {"frontend": summarize(mel[0]),
            "encoder": summarize(np.asarray(enc)[0, : max(t, 1)]),
            "logits": summarize(np.asarray(logits)[0, -1])}


def _probe_parakeet(sess, audio) -> dict:
    import jax.numpy as jnp

    from asr_jax.frontend.nemo_mel import log_mel
    from asr_jax.models import parakeet as pk

    buf, n = _first_window(sess, audio, sess.pcm_scale)
    cfg = sess.cfg
    mel = log_mel(jnp.asarray(buf), cfg.mel)
    enc, valid = pk.encode(sess.params, cfg, jnp.asarray(buf),
                           jnp.asarray([n], np.int32))
    t = int(np.asarray(valid)[0])
    h0 = jnp.zeros((cfg.lstm_layers, 1, cfg.dec_hidden), enc.dtype)
    c0 = jnp.zeros((cfg.lstm_layers, 1, cfg.dec_hidden), enc.dtype)
    tok_logits, _dur, _h, _c = pk.joint_step(
        sess.params, jnp.asarray([cfg.blank_id], jnp.int32), h0, c0, enc[:, 0])
    return {"frontend": summarize(mel[0]),
            "encoder": summarize(np.asarray(enc)[0, : max(t, 1)]),
            "logits": summarize(np.asarray(tok_logits)[0])}


def _probe_nemotron(sess, audio) -> dict:
    import jax.numpy as jnp

    from asr_jax.frontend.nemo_mel import log_mel
    from asr_jax.models import nemotron as nm

    buf, n = _first_window(sess, audio, sess.pcm_scale)
    cfg = sess.cfg
    mel = log_mel(jnp.asarray(buf), cfg.mel)
    pid = jnp.asarray([sess.prompt_id], jnp.int32)
    enc, valid = nm.encode(sess.params, cfg, jnp.asarray(buf),
                           jnp.asarray([n], np.int32), pid)
    t = int(np.asarray(valid)[0])
    h0 = jnp.zeros((cfg.lstm_layers, 1, cfg.pred_hidden), enc.dtype)
    c0 = jnp.zeros((cfg.lstm_layers, 1, cfg.pred_hidden), enc.dtype)
    logits, _h, _c = nm.joint_step(
        sess.params, jnp.asarray([cfg.blank_id], jnp.int32), h0, c0, enc[:, 0])
    return {"frontend": summarize(mel[0]),
            "encoder": summarize(np.asarray(enc)[0, : max(t, 1)]),
            "logits": summarize(np.asarray(logits)[0])}


def _probe_funasr_ctc(sess, audio) -> dict:
    import jax.numpy as jnp

    from asr_jax.frontend.kaldi_fbank import log_mel_fbank
    from asr_jax.models import fun_asr_nano as fn

    buf, n = _first_window(sess, audio, sess.pcm_scale)
    cfg = sess.cfg
    fb = cfg.fbank
    mel = log_mel_fbank(jnp.asarray(buf), fb, fb.num_frames(buf.shape[-1]))
    enc, valid_lfr, _ = fn.encode(sess.params, cfg, jnp.asarray(buf),
                                  jnp.asarray([n], np.int32))
    logits = fn.ctc_logits(sess.params, cfg, enc, valid_lfr)
    t = int(np.asarray(valid_lfr)[0])
    return {"frontend": summarize(mel[0]),
            "encoder": summarize(np.asarray(enc)[0, : max(t, 1)]),
            "logits": summarize(np.asarray(logits)[0, : max(t, 1)])}


def _llm_first_logits(llm_params, lcfg, embeds, valid: int):
    """First decode-step logits of a Qwen3-decoder prompt: the prefill's
    logits at the last valid position (exactly what the lockstep decode and
    the continuous batcher's ``_prefill_impl`` select the first token from)."""
    import jax.numpy as jnp

    from asr_jax.layers import qwen3

    if embeds.ndim == 2:
        embeds = embeds[None]
    lf = embeds.shape[1]
    state = qwen3.make_kv_state(lcfg, 1, lf, embeds.dtype)
    bias = qwen3.causal_prefill_bias(jnp.asarray([valid], np.int32), lf, lf)
    hidden, _ = qwen3.decoder_pass(llm_params, lcfg, embeds, state,
                                   jnp.asarray(0, np.int32), bias)
    h_last = hidden[0, max(valid - 1, 0)]
    return qwen3.logits_from_hidden(llm_params, lcfg, h_last[None])


def _load_samples(sess, audio, pcm_scale: float) -> np.ndarray:
    from asr_jax.runtime import audio as audio_io

    if isinstance(audio, (str, bytes)) or hasattr(audio, "__fspath__"):
        audio = audio_io.load_audio(audio, getattr(sess, "sample_rate", 16000),
                                    pcm_scale=pcm_scale)
    return np.asarray(audio, np.float32)


def _probe_qwen_asr(sess, audio) -> dict:
    import jax.numpy as jnp

    from asr_jax.frontend.whisper_mel import log_mel_spectrogram

    buf, samples = _pad_row(_load_samples(sess, audio, 1.0), sess.max_samples)
    mel = log_mel_spectrogram(jnp.asarray(buf), sess.cfg.mel_config())
    embeds, valid = sess.prompt_embeds(samples)
    logits = _llm_first_logits(sess.llm_params, sess.llm_cfg, embeds, valid)
    return {"frontend": summarize(mel[0]),
            "encoder": summarize(np.asarray(embeds)[: max(valid, 1)]),
            "logits": summarize(np.asarray(logits)[0])}


def _probe_funasr_llm(sess, audio) -> dict:
    import jax.numpy as jnp

    from asr_jax.frontend.kaldi_fbank import log_mel_fbank

    buf, samples = _pad_row(_load_samples(sess, audio, sess.pcm_scale),
                            sess.max_samples)
    fb = sess.cfg.fbank
    mel = log_mel_fbank(jnp.asarray(buf), fb, fb.num_frames(buf.shape[-1]))
    embeds, valid = sess.prompt_embeds(samples)
    logits = _llm_first_logits(sess.llm_params, sess.llm_cfg, embeds, valid)
    return {"frontend": summarize(mel[0]),
            "encoder": summarize(np.asarray(embeds)[: max(valid, 1)]),
            "logits": summarize(np.asarray(logits)[0])}


def _probe_qwen_aligner(sess, audio) -> dict:
    """Aligner: frontend mel, assembled prompt embeds, and the timestamp-
    head logits at a single ``<timestamp>`` position (no tokenizer needed —
    the probe prompt is text-free: one timestamp slot)."""
    import jax.numpy as jnp

    from asr_jax.models import forced_aligner as fa

    buf, samples = _pad_row(_load_samples(sess, audio, 1.0), sess.max_samples)
    text_ids = jnp.asarray([[sess.timestamp_id]], jnp.int32)
    mel, embeds, valid_len = fa.prompt_for(
        sess.tower_params, sess.llm_params, sess.cfg, jnp.asarray(buf),
        jnp.asarray([len(samples)], np.int32),
        sess._embed(sess.audio_start_id), sess._embed(sess.audio_end_id),
        text_ids)
    logits = fa.align_logits(sess.llm_params, sess.head, sess.cfg, embeds,
                             valid_len)
    vl = int(np.asarray(valid_len)[0])
    return {"frontend": summarize(mel[0]),
            "encoder": summarize(np.asarray(embeds)[0, : max(vl, 1)]),
            "logits": summarize(np.asarray(logits)[0, max(vl - 1, 0)])}


# ── streaming families: first-chunk features + first-chunk encoder state +
#    first emitted-token logits ──────────────────────────────────────────────


def _chunks_of(sess, audio, pcm_scale: float, size: int, advance: int,
               limit: int = 16) -> list[np.ndarray]:
    samples = _load_samples(sess, audio, pcm_scale)
    out = []
    pos = 0
    while (pos == 0 or pos + 1 <= len(samples)) and len(out) < limit:
        chunk = np.zeros(size, np.float32)
        part = samples[pos: pos + size]
        chunk[: len(part)] = part
        out.append(chunk)
        pos += advance
    return out


def _probe_paraformer_streaming(sess, audio) -> dict:
    import jax.numpy as jnp

    from asr_jax.frontend.kaldi_fbank import log_mel_fbank
    from asr_jax.streaming import paraformer_online as po

    cfg = sess.cfg
    chunks = _chunks_of(sess, audio, 32768.0, cfg.chunk_samples,
                        cfg.chunk_samples)
    fb = cfg.base.fbank
    out = {"frontend": summarize(
        log_mel_fbank(jnp.asarray(chunks[0])[None], fb,
                      fb.num_frames(cfg.chunk_samples))[0])}
    state = po.init_state(cfg, sess.params)
    for i, chunk in enumerate(chunks):
        state, fired, count, enc_out = po.encoder_step(
            sess.params, cfg, state, jnp.asarray(chunk, jnp.float32)[None])
        if i == 0:
            out["encoder"] = summarize(np.asarray(enc_out)[0])
        n_fired = int(count)
        if n_fired > 0:
            _state, logits, _count = po.decoder_step(
                sess.params, cfg, state, enc_out, fired, count,
                return_logits=True)
            out["logits"] = summarize(np.asarray(logits)[0, : n_fired])
            break
    return out


def _probe_xasr_streaming(sess, audio) -> dict:
    import jax.numpy as jnp

    from asr_jax.frontend.kaldi_fbank import log_mel_fbank
    from asr_jax.runtime.streaming_session import snip_edges_false_pad

    zf, cfg = sess.zf, sess.cfg
    samples = _load_samples(sess, audio, 32768.0)
    fbk = cfg.fbank
    padded = snip_edges_false_pad(samples, fbk.win_length, fbk.hop_length)
    window = np.zeros(cfg.window_samples, np.float32)
    part = padded[: cfg.window_samples]
    window[: len(part)] = part
    mel = log_mel_fbank(jnp.asarray(window)[None], fbk, cfg.mel_per_chunk)
    state = zf.init_state(cfg)
    context0 = state["context"]
    state, enc = zf.encoder_step(sess.params, cfg, state, jnp.asarray(window))
    d = zf.decoder_out(sess.params, cfg, context0)
    j = sess.params["joiner"]["out"]
    logits = jnp.dot(jnp.tanh(enc[0] + d), j["w"]) + j["b"]
    return {"frontend": summarize(mel[0]),
            "encoder": summarize(np.asarray(enc)),
            "logits": summarize(np.asarray(logits))}


def _probe_nemotron_streaming(sess, audio) -> dict:
    import jax.numpy as jnp

    from asr_jax.models import nemotron as nm
    from asr_jax.streaming import nemotron_stream as ns

    cfg = sess.cfg
    chunks = _chunks_of(sess, audio, 1.0, cfg.window_samples,
                        cfg.window_samples, limit=1)
    chunk = jnp.asarray(chunks[0])[None]
    mel = ns._stream_mel(cfg, chunk)
    blank = cfg.base.blank_id
    state = {**ns.init_state(cfg), "token": jnp.asarray([blank], jnp.int32)}
    pid = jnp.asarray([sess.prompt_id], jnp.int32)
    state, enc_proj = ns.encoder_step(sess.params, cfg, state, chunk, pid)
    logits, _h, _c = nm.joint_step(
        sess.params, jnp.asarray([blank], jnp.int32), state["h"], state["c"],
        enc_proj[:, 0])
    return {"frontend": summarize(mel[0]),
            "encoder": summarize(np.asarray(enc_proj)[0]),
            "logits": summarize(np.asarray(logits)[0])}


def _probe_dolphin_streaming(sess, audio) -> dict:
    import jax.numpy as jnp

    from asr_jax.frontend.kaldi_fbank import log_mel_fbank
    from asr_jax.layers.transformer import dense

    ds, cfg = sess.ds, sess.cfg
    chunks = _chunks_of(sess, audio, 32768.0, cfg.window_samples,
                        cfg.advance_samples, limit=1)
    window = jnp.asarray(chunks[0])
    mel = log_mel_fbank(window[None], cfg.fbank, cfg.window_mel)
    state = ds.init_state(cfg)
    _state, _ctc_ids, enc_out = ds.encoder_step(sess.params, cfg, state, window)
    logits = dense(enc_out, sess.params["ctc"])
    return {"frontend": summarize(mel[0]),
            "encoder": summarize(np.asarray(enc_out)[0]),
            "logits": summarize(np.asarray(logits)[0])}


_PROBES = {
    "SenseVoiceSession": _probe_sensevoice,
    "FireRedSession": _probe_firered,
    "WhisperSession": _probe_whisper,
    "ParaformerSession": _probe_paraformer,
    "DolphinSession": _probe_dolphin,
    "ParakeetSession": _probe_parakeet,
    "NemotronSession": _probe_nemotron,
    "FunAsrNanoCtcSession": _probe_funasr_ctc,
    "QwenAsrSession": _probe_qwen_asr,
    "FunAsrNanoLlmSession": _probe_funasr_llm,
    "QwenAlignerSession": _probe_qwen_aligner,
    "ParaformerStreamingSession": _probe_paraformer_streaming,
    "XasrStreamingSession": _probe_xasr_streaming,
    "NemotronStreamingSession": _probe_nemotron_streaming,
    "DolphinStreamingSession": _probe_dolphin_streaming,
}


def capture_probe(sess, audio) -> dict | None:
    """First-window stage snapshots for ``sess``, or None when the family
    has no probe hook (the golden then carries transcripts only)."""
    fn = _PROBES.get(type(sess).__name__)
    if fn is None:
        return None
    out = fn(sess, audio)
    return {k: out[k] for k in STAGE_ORDER if k in out}
