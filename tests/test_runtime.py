"""Runtime: audio ingest on the seeded fixtures, tokenizers, artifact
roundtrip, sliding-window session."""

import struct

import numpy as np
import pytest
import jax

from asr_jax.models import sensevoice as sv
from asr_jax.runtime import audio as audio_io
from asr_jax.runtime.artifact import flatten_pytree, load_model, save_model, unflatten_pytree
from asr_jax.runtime.examples import fixture_path
from asr_jax.runtime.metadata import LanguageProfile, ModelMetadata
from asr_jax.runtime.session import SenseVoiceSession
from asr_jax.runtime.tokenizer import SentencePieceDecoder, VocabTxtDecoder

TINY = sv.SenseVoiceConfig(
    vocab_size=64, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
    num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5,
)


def test_load_audio_fixture_resampled_mono():
    audio = audio_io.load_audio(fixture_path("en/test_sample.wav"), 16000)
    assert audio.ndim == 1
    assert audio.dtype == np.float32
    # 268292 frames at 48 kHz -> ~89430 at 16 kHz
    assert abs(len(audio) - 268292 / 3) < 5
    assert np.abs(audio).max() > 100  # int16 numeric range


def test_flac_fixture_holds_the_wav_samples():
    """The generated FLAC stand-in decodes (Python decoder and load_audio)
    to exactly the samples of its WAV twin."""
    from asr_jax.runtime.flac import read_flac

    flac, rate = read_flac(fixture_path("zh/zh-Shanghai.flac"))
    wav, wav_rate = audio_io.read_wav(fixture_path("zh/zh-Shanghai.wav"))
    assert rate == wav_rate == 16000
    np.testing.assert_array_equal(flac.reshape(wav.shape), wav)
    np.testing.assert_array_equal(
        audio_io.load_audio(fixture_path("zh/zh-Shanghai.flac"), 16000),
        audio_io.load_audio(fixture_path("zh/zh-Shanghai.wav"), 16000))


def test_resample_identity_and_rate():
    x = np.sin(np.linspace(0, 100, 48000)).astype(np.float32)
    assert audio_io.resample(x, 16000, 16000) is x
    y = audio_io.resample(x, 48000, 16000)
    assert len(y) == 16000


def _encode_varint(v):
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _sp_piece(piece, score=0.0, ptype=None):
    body = b"\x0a" + _encode_varint(len(piece.encode())) + piece.encode()
    body += b"\x15" + struct.pack("<f", score)
    if ptype is not None:
        body += b"\x18" + _encode_varint(ptype)
    return b"\x0a" + _encode_varint(len(body)) + body


def test_sentencepiece_decoder_roundtrip(tmp_path):
    model = b"".join(
        [
            _sp_piece("<unk>", 0.0, 2),
            _sp_piece("<s>", 0.0, 3),
            _sp_piece("▁hello", -1.0),
            _sp_piece("▁wor", -2.0),
            _sp_piece("ld", -3.0),
            _sp_piece("<0xE4>", 0.0, 6),
            _sp_piece("<0xB8>", 0.0, 6),
            _sp_piece("<0xAD>", 0.0, 6),
            _sp_piece("<|zh|>", 0.0, 4),
        ]
    )
    p = tmp_path / "sp.model"
    p.write_bytes(model)
    dec = SentencePieceDecoder(p)
    assert len(dec) == 9
    assert dec.decode([2, 3, 4]) == " hello world"
    assert dec.decode([5, 6, 7]) == "中"  # byte pieces reassembled as UTF-8
    assert dec.decode([8, 2]) == "<|zh|> hello"


def test_vocab_txt_decoder(tmp_path):
    p = tmp_path / "vocab.txt"
    p.write_text("<blank>\n你\n好\n</s>\n", encoding="utf-8")
    dec = VocabTxtDecoder(p)
    assert dec.decode([1, 2, 0, 3]) == "你好"


def test_metadata_roundtrip(tmp_path):
    md = ModelMetadata(
        family="sensevoice",
        special_token_ids={"blank": 0},
        supported_languages=[
            LanguageProfile("zh", "Chinese", ("Mandarin", "zh-CN"), 3, 1),
            LanguageProfile("en", "English", (), 4, 2),
        ],
        tokenizer={"kind": "sentencepiece", "file": "chn_jpn_yue_eng_ko_spectok.bpe.model"},
        extra={"lfr_m": 7},
    )
    md.save(tmp_path)
    back = ModelMetadata.load(tmp_path)
    assert back.family == "sensevoice"
    assert back.resolve_language("Mandarin").prompt_token_id == 3
    assert back.extra["lfr_m"] == 7
    with pytest.raises(KeyError):
        back.resolve_language("klingon")


def test_artifact_roundtrip(tmp_path):
    params = sv.init_params(TINY, jax.random.PRNGKey(0))
    md = ModelMetadata(family="sensevoice")
    save_model(tmp_path / "m", params, md)
    loaded, md2 = load_model(tmp_path / "m")
    flat_a = flatten_pytree(params)
    flat_b = flatten_pytree(loaded)
    assert set(flat_a) == set(flat_b)
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k])
    assert md2.family == "sensevoice"


def test_flatten_unflatten_lists():
    tree = {"a": [{"w": np.zeros(2)}, {"w": np.ones(2)}], "b": np.arange(3)}
    flat = flatten_pytree(tree)
    assert set(flat) == {"a/0/w", "a/1/w", "b"}
    back = unflatten_pytree(flat)
    assert isinstance(back["a"], list) and len(back["a"]) == 2


class _IdsTokenizer:
    def decode(self, ids):
        return " ".join(str(i) for i in ids)


def test_session_sliding_window_long_audio():
    params = sv.init_params(TINY, jax.random.PRNGKey(1))
    sess = SenseVoiceSession(params, TINY, tokenizer=_IdsTokenizer(), window_seconds=0.5)
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(int(16000 * 1.3)) * 2000).astype(np.float32)
    res = sess.transcribe(audio)  # 3 windows: 0.5 + 0.5 + 0.3
    assert res.audio_seconds == pytest.approx(1.3)
    assert res.rtf > 0
    assert isinstance(res.text, str) and res.token_ids is not None


def test_session_on_fixture_file():
    params = sv.init_params(TINY, jax.random.PRNGKey(2))
    sess = SenseVoiceSession(params, TINY, window_seconds=8.0)
    res = sess.transcribe(fixture_path("en/test_sample.wav"), language="en")
    assert res.audio_seconds > 5


def test_weight_dedup_aliases(tmp_path):
    """Byte-identical tensors stored once; load restores both paths sharing
    ONE device buffer (reference shared-initializer dedup analog)."""
    import jax.numpy as jnp
    from asr_jax.runtime.artifact import WEIGHTS_FILENAME, load_model, save_model
    from asr_jax.runtime.metadata import ModelMetadata

    rng = np.random.default_rng(0)
    big = rng.standard_normal((256, 64)).astype(np.float32)
    params = {"embed": {"w": jnp.asarray(big)},
              "lm_head": {"w": jnp.asarray(big)},          # tied
              "other": {"w": jnp.asarray(big + 1.0)},
              "tiny": jnp.zeros((4,), jnp.float32)}
    save_model(tmp_path / "m", params, ModelMetadata(family="x"))

    meta = ModelMetadata.load(tmp_path / "m")
    assert meta.extra["weight_aliases"] == {"lm_head/w": "embed/w"}
    from asr_jax.runtime.artifact import load_safetensors
    stored = load_safetensors(tmp_path / "m" / WEIGHTS_FILENAME)
    assert "lm_head/w" not in stored and "embed/w" in stored

    loaded, _ = load_model(tmp_path / "m")
    np.testing.assert_array_equal(np.asarray(loaded["lm_head/w".split("/")[0]]["w"]),
                                  big)
    # one physical buffer for the tied pair
    assert loaded["embed"]["w"] is loaded["lm_head"]["w"]
    assert loaded["other"]["w"] is not loaded["embed"]["w"]


def test_stage_timer_and_trace(tmp_path):
    import time as _time
    import jax.numpy as jnp
    from asr_jax.runtime.profiling import StageTimer, annotate, trace

    t = StageTimer()
    with t("encode"):
        _time.sleep(0.01)
    with t("decode", items=50):
        _time.sleep(0.01)
    with t("decode", items=50):
        pass
    assert t.totals["encode"] >= 0.01
    assert t.counts["decode"] == 2 and t.items["decode"] == 100
    rep = t.report(audio_seconds=1.0)
    assert "RTF" in rep and "items/s" in rep and "decode" in rep

    with trace(str(tmp_path / "prof")):
        with annotate("matmul"):
            (jnp.ones((32, 32)) @ jnp.ones((32, 32))).block_until_ready()
    # xprof wrote something under the logdir
    assert any((tmp_path / "prof").rglob("*"))


def test_load_audio_batch_native_and_fallback(tmp_path):
    import wave
    from asr_jax.runtime.audio import load_audio, load_audio_batch

    rng = np.random.default_rng(0)
    paths = []
    for i, (rate, ch, n) in enumerate([(16000, 1, 6000), (8000, 2, 4000)]):
        p = tmp_path / f"f{i}.wav"
        with wave.open(str(p), "wb") as w:
            w.setnchannels(ch); w.setsampwidth(2); w.setframerate(rate)
            w.writeframes((rng.standard_normal(n * ch) * 3000).astype(np.int16).tobytes())
        paths.append(p)

    batch, valid = load_audio_batch(paths, 16000, 16000)
    assert batch.shape == (2, 16000)
    for i, p in enumerate(paths):
        ref = load_audio(p, 16000)
        assert valid[i] == min(len(ref), 16000)
        np.testing.assert_allclose(batch[i, : valid[i]], ref[: valid[i]], atol=1.5)
        assert (batch[i, valid[i]:] == 0).all()

    # [-1, 1] convention
    b2, _ = load_audio_batch(paths, 16000, 16000, pcm_scale=1.0)
    np.testing.assert_allclose(b2, batch / 32768.0, atol=1e-6)

    # undecodable rows (nonexistent/malformed) become silent zero-length
    # rows instead of aborting the whole batch.
    bmiss, vmiss = load_audio_batch([tmp_path / "missing.wav"], 16000, 16000)
    assert vmiss[0] == 0 and (bmiss == 0).all()


def test_sensevoice_transcribe_batch(tmp_path):
    import wave
    import jax
    from asr_jax.models import sensevoice as sv
    from asr_jax.runtime.session import SenseVoiceSession

    cfg = sv.SenseVoiceConfig(
        vocab_size=64, hidden=32, num_heads=4, head_dim=8, ffn_dim=64,
        num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5,
    )
    params = sv.init_params(cfg, jax.random.PRNGKey(0))
    sess = SenseVoiceSession(params, cfg, window_seconds=1.0)

    rng = np.random.default_rng(0)
    paths, raws = [], []
    # third file OVERFLOWS the 1 s window -> sliding-window fallback row
    for i, n in enumerate([12000, 13000, 40000]):
        p = tmp_path / f"s{i}.wav"
        raw = (rng.standard_normal(n) * 3000).astype(np.int16)
        with wave.open(str(p), "wb") as w:
            w.setnchannels(1); w.setsampwidth(2); w.setframerate(16000)
            w.writeframes(raw.tobytes())
        paths.append(p)
        raws.append(raw)

    batch_res = sess.transcribe_batch(paths)
    assert len(batch_res) == 3
    for i, (p, res) in enumerate(zip(paths, batch_res)):
        single = sess.transcribe(raws[i].astype(np.float32))
        assert res.token_ids == single.token_ids, f"file {i}"
        assert res.audio_seconds == pytest.approx(len(raws[i]) / 16000)


def test_iter_windows_geometry():
    """The ONE windowing definition (audio.iter_windows) shared by sessions
    and the HTTP server: short audio -> one window; exact multiples don't
    produce an empty trailing window; overlap strides cover the tail."""
    from asr_jax.runtime.audio import iter_windows

    assert iter_windows(0, 100, 100) == [0]
    assert iter_windows(99, 100, 100) == [0]
    assert iter_windows(100, 100, 100) == [0]
    assert iter_windows(101, 100, 100) == [0, 100]
    assert iter_windows(200, 100, 100) == [0, 100]
    assert iter_windows(201, 100, 100) == [0, 100, 200]
    # overlapping stride: every sample is covered and the last window
    # reaches the end
    starts = iter_windows(250, 100, 60)
    assert starts == [0, 60, 120, 180]
    assert starts[-1] + 100 >= 250
