"""ForcedAligner: NAR pass shapes, timestamp monotone repair semantics."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from asr_jax.layers import qwen3
from asr_jax.models import forced_aligner as fa
from asr_jax.models import qwen_asr as qa


def test_fix_timestamps_monotone_repair():
    # already monotone -> unchanged
    assert fa.fix_timestamps([1, 2, 2, 5]) == [1, 2, 2, 5]
    # single glitch snaps to neighbor anchor
    assert fa.fix_timestamps([1, 2, 100, 3, 4])[2] in (2, 3)
    out = fa.fix_timestamps([1, 2, 100, 3, 4])
    assert all(out[i] <= out[i + 1] for i in range(len(out) - 1))
    # long anomaly run -> interpolation between surrounding anchors
    out = fa.fix_timestamps([1, 2, 50, 50, 50, 50, 3, 4, 5, 6, 7])
    assert out[:2] == [1, 2] and out[6:] == [3, 4, 5, 6, 7]
    assert all(2 <= v <= 3 for v in out[2:6])
    assert fa.fix_timestamps([]) == []


def test_word_timestamps_grouping():
    words = ["foo", "bar"]
    buckets = [1, 2, 5, 6]
    out = fa.word_timestamps(words, buckets, tokens_per_word=2, segment_ms=80)
    assert out[0] == {"text": "foo", "start_ms": 80, "end_ms": 160}
    assert out[1] == {"text": "bar", "start_ms": 400, "end_ms": 480}


def test_nar_forward_shapes():
    lcfg = qwen3.Qwen3Config(vocab_size=100, hidden=48, num_layers=1, num_heads=4,
                             num_kv_heads=2, head_dim=16, ffn_dim=64, rope_theta=1e4)
    acfg = qa.QwenAsrConfig(
        n_mels=16, tower_dim=32, tower_layers=1, tower_heads=4, tower_ffn=48,
        downsample_hidden=8, chunks_per_window=2, output_dim=lcfg.hidden, llm=lcfg,
    )
    cfg = fa.ForcedAlignerConfig(asr=acfg, classify_num=25)
    tower = qa.init_tower_params(acfg, jax.random.PRNGKey(0))
    llm = qwen3.init_params(lcfg, jax.random.PRNGKey(1))
    head = {"w": jax.random.normal(jax.random.PRNGKey(2), (lcfg.hidden, 25)) * 0.1}
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((1, 32000)) * 0.1).astype(np.float32)
    start = llm["embed"][jnp.asarray([[7]])]
    end = llm["embed"][jnp.asarray([[8]])]
    text_ids = jnp.asarray([[11, 12, 5, 5, 13, 5, 5]], jnp.int32)  # 5 = <timestamp>
    buckets, valid = fa.forward(
        tower, llm, head, cfg, jnp.asarray(audio), jnp.asarray([32000]), start, end, text_ids
    )
    assert buckets.shape[0] == 1
    v = int(valid[0])
    b = np.asarray(buckets)[0]
    assert ((b >= 0) & (b < 25)).all()
    # timestamp positions live at 1 + audio_valid + 1 + idx
    mel_frames = 32000 // 160
    audio_valid = int(qa.feat_output_len(jnp.asarray(mel_frames)))
    assert v == 1 + audio_valid + 1 + text_ids.shape[1]


def test_word_units_splitter():
    from asr_jax.runtime.aligner_session import word_units

    assert word_units("Hello, world!") == ["Hello", "world"]
    assert word_units("don't stop") == ["don't", "stop"]
    assert word_units("我爱 NLP") == ["我", "爱", "NLP"]
    assert word_units("abc你好def") == ["abc", "你", "好", "def"]
    assert word_units("  ...  ") == []
    assert word_units("v2ray 2024") == ["v2ray", "2024"]


def test_word_units_japanese_script_segmenter():
    from asr_jax.runtime.aligner_session import (
        word_units_for_language,
        word_units_japanese,
    )

    # kanji + trailing hiragana (okurigana) form one unit; katakana runs and
    # latin runs are their own units; punctuation splits.
    assert word_units_japanese("私は東京タワーへ行きました。") == [
        "私は", "東京", "タワー", "へ", "行きました"]
    assert word_units_japanese("カタカナABC123ひらがな") == [
        "カタカナ", "ABC123", "ひらがな"]
    assert word_units_japanese("ラーメン") == ["ラーメン"]  # prolonged mark stays
    assert word_units_japanese("") == []

    # dispatch: ja aliases use the segmenter, Korean/others the space splitter
    assert word_units_for_language("行きます", "ja") == ["行きます"]
    assert word_units_for_language("안녕하세요 세계", "korean") == ["안녕하세요", "세계"]
    assert word_units_for_language("hello world", None) == ["hello", "world"]


def test_word_units_japanese_mixed_scripts():
    from asr_jax.runtime.aligner_session import word_units_japanese

    # hiragana run after katakana starts its own unit (no okurigana
    # attachment across non-kanji scripts); a kanji after attached
    # okurigana starts a new unit (compound verbs split at the boundary).
    assert word_units_japanese("データを読み込む") == ["データ", "を", "読み", "込む"]


def test_aligner_session_end_to_end():
    import jax
    import numpy as np
    from asr_jax.layers import qwen3
    from asr_jax.models import qwen_asr as qa
    from asr_jax.runtime.aligner_session import QwenAlignerSession

    lcfg = qwen3.Qwen3Config(vocab_size=120, hidden=48, num_layers=1, num_heads=4,
                             num_kv_heads=2, head_dim=16, ffn_dim=64, rope_theta=1e4)
    acfg = qa.QwenAsrConfig(
        n_mels=16, tower_dim=32, tower_layers=1, tower_heads=4, tower_ffn=48,
        downsample_hidden=8, chunks_per_window=2, output_dim=lcfg.hidden, llm=lcfg, eot_id=-1,
    )
    cfg = fa.ForcedAlignerConfig(asr=acfg, classify_num=25, segment_ms=80)
    tower = qa.init_tower_params(acfg, jax.random.PRNGKey(0))
    llm = qwen3.init_params(lcfg, jax.random.PRNGKey(1))
    head = {"w": jax.random.normal(jax.random.PRNGKey(2), (lcfg.hidden, cfg.classify_num)) * 0.1}

    class _Tok:
        def encode(self, text):
            return [ord(c) % 100 for c in text][:3]

    sess = QwenAlignerSession(
        tower, llm, head, cfg, tokenizer=_Tok(),
        special_ids={"timestamp": 110, "audio_start": 111, "audio_end": 112},
        tokens_per_word=2, max_seconds=2.0,
    )
    rng = np.random.default_rng(0)
    out = sess.align((rng.standard_normal(24000) * 0.1).astype(np.float32), "hello world again")
    assert [o["text"] for o in out] == ["hello", "world", "again"]
    for o in out:
        assert 0 <= o["start_ms"] <= o["end_ms"] <= (cfg.classify_num - 1) * cfg.segment_ms
    assert sess.align(np.zeros(1000, np.float32), "...") == []


def test_aligner_session_with_quantized_embeddings():
    """quantize --quantize-embeddings artifacts must still align: the
    session's special-token embed lookup goes through the
    QuantizedEmbedding gather instead of jnp.asarray (regression)."""
    import jax
    import numpy as np
    from asr_jax.layers import qwen3
    from asr_jax.models import qwen_asr as qa
    from asr_jax.quant.quantize import quantize_embedding
    from asr_jax.runtime.aligner_session import QwenAlignerSession

    lcfg = qwen3.Qwen3Config(vocab_size=120, hidden=48, num_layers=1, num_heads=4,
                             num_kv_heads=2, head_dim=16, ffn_dim=64, rope_theta=1e4)
    acfg = qa.QwenAsrConfig(
        n_mels=16, tower_dim=32, tower_layers=1, tower_heads=4, tower_ffn=48,
        downsample_hidden=8, chunks_per_window=2, output_dim=lcfg.hidden, llm=lcfg, eot_id=-1,
    )
    cfg = fa.ForcedAlignerConfig(asr=acfg, classify_num=25, segment_ms=80)
    tower = qa.init_tower_params(acfg, jax.random.PRNGKey(0))
    llm = qwen3.init_params(lcfg, jax.random.PRNGKey(1))
    llm["embed"] = quantize_embedding(jax.numpy.asarray(llm["embed"]), bits=8, block=48)
    head = {"w": jax.random.normal(jax.random.PRNGKey(2), (lcfg.hidden, cfg.classify_num)) * 0.1}

    class _Tok:
        def encode(self, text):
            return [ord(c) % 100 for c in text][:3]

    sess = QwenAlignerSession(
        tower, llm, head, cfg, tokenizer=_Tok(),
        special_ids={"timestamp": 110, "audio_start": 111, "audio_end": 112},
        tokens_per_word=1, max_seconds=1.0,
    )
    rng = np.random.default_rng(0)
    out = sess.align((rng.standard_normal(12000) * 0.1).astype(np.float32), "hello world")
    assert [o["text"] for o in out] == ["hello", "world"]


def test_word_units_korean_eojeol_and_language_dispatch():
    """Korean alignment units are space-delimited eojeol (the reference's
    untrained-LTokenizer equivalent); language dispatch routes ja -> the
    script segmenter and ko/unknown -> the default splitter."""
    from asr_jax.runtime.aligner_session import (
        word_units, word_units_for_language,
    )

    text = "안녕하세요 저는 학생입니다"
    assert word_units_for_language(text, "korean") == \
        ["안녕하세요", "저는", "학생입니다"]
    assert word_units_for_language(text, "ko") == word_units(text)
    # punctuation dropped, units kept whole (not per-syllable)
    assert word_units_for_language("좋아요, 감사합니다!", "ko") == \
        ["좋아요", "감사합니다"]
    # ja goes to the script segmenter: kanji+trailing-hiragana units
    got = word_units_for_language("私は走った", "ja")
    assert got == ["私は", "走った"], got
