"""Stage-activation probes cover EVERY session class (VERDICT r4 #2).

The parity harness (``asr_jax parity``) rides these probes: when the
BASELINE token-for-token gate finally runs against real checkpoints, the
first drifting stage localizes a transcript mismatch to
front-end / encoder / decode without a manual bisect. Reference equivalent:
running the per-stage ONNX sessions individually
(``/root/reference/Whisper/Inference_Whisper_ONNX.py:493-550``).

Each family: capture -> self-compare clean -> stage-drift localizes.
"""

import numpy as np
import pytest
import jax

from asr_jax.runtime.probe import STAGE_ORDER, capture_probe, compare_probes


def _noise(seed, n, scale):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _sensevoice():
    from asr_jax.models import sensevoice as sv
    from asr_jax.runtime.session import SenseVoiceSession

    cfg = sv.SenseVoiceConfig(vocab_size=64, hidden=32, num_heads=4, head_dim=8,
                              ffn_dim=48, num_encoders0=1, num_encoders=1,
                              num_tp_encoders=1, fsmn_kernel=5)
    sess = SenseVoiceSession(sv.init_params(cfg, jax.random.PRNGKey(0)), cfg,
                             window_seconds=0.5)
    return sess, _noise(0, 8000, 2000)


def _whisper():
    from asr_jax.models import whisper as wh
    from asr_jax.runtime.whisper_session import WhisperSession

    cfg = wh.WhisperConfig(
        vocab_size=96, d_model=32, encoder_layers=1, decoder_layers=1,
        num_heads=4, n_mels=16, max_source_positions=40,
        max_target_positions=24, sot_id=1, eot_id=2, first_language_id=10,
        num_languages=4, no_speech_id=30)
    sess = WhisperSession(wh.init_params(cfg, jax.random.PRNGKey(1)), cfg,
                          window_seconds=0.8)
    return sess, _noise(1, 6400, 0.05)


def _firered():
    from asr_jax.models import firered as fr
    from asr_jax.runtime.transducer_session import FireRedSession

    cfg = fr.FireRedConfig(vocab_size=60, d_model=32, enc_layers=1, enc_heads=4,
                           conv_kernel=9, dec_layers=1, dec_heads=4, dec_ffn=48,
                           max_target_positions=16)
    sess = FireRedSession(fr.init_params(cfg, jax.random.PRNGKey(2)), cfg,
                          window_seconds=1.0)
    return sess, _noise(2, 8000, 2000)


def _paraformer():
    from asr_jax.models import paraformer as pf
    from asr_jax.runtime.transducer_session import ParaformerSession

    cfg = pf.ParaformerConfig(vocab_size=50, hidden=32, num_heads=4, head_dim=8,
                              ffn_dim=48, num_encoders0=1, num_encoders=1,
                              num_decoders=1, num_decoder_ffn=1, fsmn_kernel=5,
                              predictor_kernel=3)
    sess = ParaformerSession(pf.init_params(cfg, jax.random.PRNGKey(3)), cfg,
                             window_seconds=1.0)
    return sess, _noise(3, 8000, 2000)


def _dolphin():
    from asr_jax.models import dolphin as dp
    from asr_jax.runtime.transducer_session import DolphinSession

    cfg = dp.DolphinConfig(vocab_size=60, d_model=32, enc_layers=1, enc_heads=4,
                           enc_ffn=48, cgmlp_dim=48, csgu_kernel=5,
                           fusion_kernel=3, dec_layers=1, dec_heads=4,
                           dec_ffn=48, sos_id=50, eos_id=51,
                           max_target_positions=16)
    sess = DolphinSession(dp.init_params(cfg, jax.random.PRNGKey(4)), cfg,
                          window_seconds=1.0)
    return sess, _noise(4, 8000, 2000)


def _parakeet():
    from asr_jax.frontend.nemo_mel import NemoMelConfig
    from asr_jax.models import parakeet as pk
    from asr_jax.runtime.transducer_session import ParakeetSession

    cfg = pk.ParakeetConfig(vocab_size=40, d_model=32, num_layers=1,
                            num_heads=4, ffn_dim=48, conv_kernel=5,
                            sub_channels=8, dec_hidden=16, lstm_layers=1,
                            mel=NemoMelConfig(n_mels=40))
    sess = ParakeetSession(pk.init_params(cfg, jax.random.PRNGKey(5)), cfg,
                           window_seconds=1.0)
    return sess, _noise(5, 8000, 0.1)


def _nemotron():
    from asr_jax.frontend.nemo_mel import NemoMelConfig
    from asr_jax.models import nemotron as nm
    from asr_jax.runtime.transducer_session import NemotronSession

    cfg = nm.NemotronConfig(vocab_size=30, d_model=32, num_layers=1,
                            num_heads=4, ffn_dim=48, conv_kernel=5,
                            sub_channels=8, pred_hidden=16, joint_hidden=16,
                            prompt_hidden=16, lstm_layers=1, num_prompts=4,
                            left_context=6, right_context=3,
                            mel=NemoMelConfig(n_mels=40))
    sess = NemotronSession(nm.init_params(cfg, jax.random.PRNGKey(6)), cfg,
                           window_seconds=1.0)
    return sess, _noise(6, 8000, 0.1)


def _funasr_ctc():
    from asr_jax.models import fun_asr_nano as fn
    from asr_jax.runtime.transducer_session import FunAsrNanoCtcSession

    cfg = _funasr_cfg()
    sess = FunAsrNanoCtcSession(fn.init_params(cfg, jax.random.PRNGKey(7)),
                                cfg, window_seconds=1.0)
    return sess, _noise(7, 8000, 2000)


def _llm_cfg():
    from asr_jax.layers import qwen3

    return qwen3.Qwen3Config(vocab_size=120, hidden=48, num_layers=1,
                             num_heads=4, num_kv_heads=2, head_dim=16,
                             ffn_dim=64, rope_theta=1e4)


def _funasr_cfg():
    from asr_jax.models import fun_asr_nano as fn

    return fn.FunAsrNanoConfig(hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
                               num_encoders0=1, num_encoders=1,
                               num_tp_encoders=1, fsmn_kernel=5,
                               adaptor_hidden=48, adaptor_blocks=1,
                               adaptor_heads=4, adaptor_ffn=64, ctc_hidden=32,
                               ctc_blocks=1, ctc_heads=4, ctc_ffn=48,
                               ctc_vocab=50, llm=_llm_cfg(), eot_id=-1)


def _qwen_asr():
    from asr_jax.layers import qwen3
    from asr_jax.models import qwen_asr as qa
    from asr_jax.runtime.qwen_session import QwenAsrSession

    lcfg = _llm_cfg()
    cfg = qa.QwenAsrConfig(n_mels=16, tower_dim=32, tower_layers=1,
                           tower_heads=4, tower_ffn=48, downsample_hidden=8,
                           chunks_per_window=2, output_dim=lcfg.hidden,
                           llm=lcfg, eot_id=1)
    sess = QwenAsrSession(qa.init_tower_params(cfg, jax.random.PRNGKey(8)),
                          qwen3.init_params(lcfg, jax.random.PRNGKey(9)),
                          cfg, max_seconds=2.0, max_new_tokens=4)
    return sess, _noise(8, 8000, 0.1)


def _funasr_llm():
    from asr_jax.layers import qwen3
    from asr_jax.models import fun_asr_nano as fn
    from asr_jax.runtime.qwen_session import FunAsrNanoLlmSession

    cfg = _funasr_cfg()
    sess = FunAsrNanoLlmSession(fn.init_params(cfg, jax.random.PRNGKey(10)),
                                qwen3.init_params(cfg.llm, jax.random.PRNGKey(11)),
                                cfg, max_seconds=2.0, max_new_tokens=4)
    return sess, _noise(9, 8000, 2000)


def _qwen_aligner():
    from asr_jax.layers import qwen3
    from asr_jax.models import forced_aligner as fa
    from asr_jax.models import qwen_asr as qa
    from asr_jax.runtime.aligner_session import QwenAlignerSession

    lcfg = _llm_cfg()
    cfg = qa.QwenAsrConfig(n_mels=16, tower_dim=32, tower_layers=1,
                           tower_heads=4, tower_ffn=48, downsample_hidden=8,
                           chunks_per_window=2, output_dim=lcfg.hidden,
                           llm=lcfg, eot_id=1)
    acfg = fa.ForcedAlignerConfig(asr=cfg, classify_num=25, segment_ms=80)
    head = {"w": np.asarray(
        jax.random.normal(jax.random.PRNGKey(12), (lcfg.hidden, 25))) * 0.1}
    sess = QwenAlignerSession(
        qa.init_tower_params(cfg, jax.random.PRNGKey(13)),
        qwen3.init_params(lcfg, jax.random.PRNGKey(14)), head, acfg,
        tokenizer=None,
        special_ids={"timestamp": 110, "audio_start": 111, "audio_end": 112},
        max_seconds=2.0)
    return sess, _noise(10, 8000, 0.1)


def _paraformer_streaming():
    from asr_jax.models import paraformer as pf
    from asr_jax.runtime.streaming_session import ParaformerStreamingSession
    from asr_jax.streaming import paraformer_online as po

    base = pf.ParaformerConfig(vocab_size=50, hidden=32, num_heads=4,
                               head_dim=8, ffn_dim=48, num_encoders0=1,
                               num_encoders=1, num_decoders=1,
                               num_decoder_ffn=1, fsmn_kernel=5,
                               predictor_kernel=3)
    cfg = po.ParaformerStreamConfig(base=base, chunk_samples=8000)
    sess = ParaformerStreamingSession(
        pf.init_params(base, jax.random.PRNGKey(15)), cfg)
    return sess, _noise(11, 24000, 2000)


def _xasr_streaming():
    from asr_jax.models import zipformer as zf
    from asr_jax.runtime.streaming_session import XasrStreamingSession

    cfg = zf.ZipformerConfig(
        vocab_size=40, downsampling_factor=(1, 2), num_encoder_layers=(1, 1),
        encoder_dim=(32, 48), query_head_dim=(8, 8), pos_head_dim=(4, 4),
        value_head_dim=(8, 8), num_heads=(2, 2), feedforward_dim=(48, 64),
        cnn_module_kernel=(7, 7))
    sess = XasrStreamingSession(zf.init_params(cfg, jax.random.PRNGKey(16)),
                                cfg)
    return sess, _noise(12, cfg.window_samples, 2000)


def _nemotron_streaming():
    from asr_jax.frontend.nemo_mel import NemoMelConfig
    from asr_jax.models import nemotron as nm
    from asr_jax.runtime.streaming_session import NemotronStreamingSession
    from asr_jax.streaming import nemotron_stream as ns

    base = nm.NemotronConfig(vocab_size=30, d_model=32, num_layers=2,
                             num_heads=4, ffn_dim=48, conv_kernel=5,
                             sub_channels=8, pred_hidden=16, joint_hidden=16,
                             prompt_hidden=16, lstm_layers=1, num_prompts=4,
                             left_context=8, right_context=3,
                             mel=NemoMelConfig(n_mels=40))
    cfg = ns.NemotronStreamConfig(base=base)
    sess = NemotronStreamingSession(nm.init_params(base, jax.random.PRNGKey(17)),
                                    cfg)
    return sess, _noise(13, cfg.window_samples, 0.1)


def _dolphin_streaming():
    from asr_jax.models import dolphin as dp
    from asr_jax.runtime.streaming_session import DolphinStreamingSession
    from asr_jax.streaming import dolphin_stream as ds

    base = dp.DolphinConfig(vocab_size=60, d_model=32, enc_layers=2,
                            enc_heads=4, enc_ffn=48, cgmlp_dim=64,
                            csgu_kernel=5, fusion_kernel=3, dec_layers=2,
                            dec_heads=4, dec_ffn=48, sos_id=50, eos_id=51,
                            max_target_positions=24)
    cfg = ds.DolphinStreamConfig(base=base, chunk_frames=8, max_frames=64)
    sess = DolphinStreamingSession(dp.init_params(base, jax.random.PRNGKey(18)),
                                   cfg)
    return sess, _noise(14, cfg.window_samples, 2000)


_FAMILIES = {
    "sensevoice": _sensevoice,
    "whisper": _whisper,
    "firered": _firered,
    "paraformer": _paraformer,
    "dolphin": _dolphin,
    "parakeet": _parakeet,
    "nemotron": _nemotron,
    "fun_asr_nano_ctc": _funasr_ctc,
    "qwen_asr": _qwen_asr,
    "fun_asr_nano_llm": _funasr_llm,
    "qwen_aligner": _qwen_aligner,
    "paraformer_streaming": _paraformer_streaming,
    "x_asr": _xasr_streaming,
    "nemotron_streaming": _nemotron_streaming,
    "dolphin_streaming": _dolphin_streaming,
}


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_capture_compare_roundtrip(family):
    """Every session class has a probe hook: capture returns stage
    snapshots, a self-compare is clean, and a mutated stage is localized
    to THAT stage (first-drift-wins ordering)."""
    sess, audio = _FAMILIES[family]()
    p = capture_probe(sess, audio)
    assert p is not None, f"{type(sess).__name__} has no probe hook"
    assert set(p) <= set(STAGE_ORDER)
    # frontend + encoder always; logits may be absent only for a streaming
    # family whose predictor never fired on this audio
    assert "frontend" in p
    assert ("encoder" in p) or family == "sensevoice"  # CTC-in-one-graph
    assert compare_probes(p, p) == []

    first = next(s for s in STAGE_ORDER if s in p)
    bad = {**p, first: {**p[first],
                        "head": [v + 1.0 for v in p[first]["head"]]}}
    msgs = compare_probes(bad, p)
    assert msgs and f"stage {first!r}" in msgs[0]


def test_spread_field_localizes_tail_drift():
    """A drift confined to late elements (past the head sample) is caught
    by the strided spread sample (r4 advisor finding)."""
    from asr_jax.runtime.probe import summarize

    a = np.zeros(4096, np.float32)
    want = summarize(a)
    b = a.copy()
    b[-1] = 50.0  # far past head[48]; mean/std shift is tiny
    got = summarize(b)
    msgs = compare_probes({"frontend": got}, {"frontend": want})
    assert msgs and "spread" in msgs[0]
