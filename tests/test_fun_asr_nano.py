"""Fun-ASR-Nano: CTC head behavior, adaptor truncation convention,
LLM-path pipeline, padded-batch invariance of the CTC path."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from asr_jax.decode.ar import DecodeConfig
from asr_jax.layers import qwen3
from asr_jax.loaders.qwen3_hf import config_from_hf, params_from_state_dict
from asr_jax.models import fun_asr_nano as fn

TINY = fn.FunAsrNanoConfig(
    hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
    num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5,
    adaptor_hidden=48, adaptor_blocks=1, adaptor_heads=4, adaptor_ffn=64,
    ctc_hidden=32, ctc_blocks=1, ctc_heads=4, ctc_ffn=48, ctc_vocab=50,
    llm=qwen3.Qwen3Config(vocab_size=120, hidden=48, num_layers=1, num_heads=4,
                          num_kv_heads=2, head_dim=16, ffn_dim=64, rope_theta=1e4),
)


def test_forward_ctc_shapes_and_padded_invariance():
    params = fn.init_params(TINY, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    short = (rng.standard_normal(6400) * 2000).astype(np.float32)
    ids1, n1 = fn.forward_ctc(params, TINY, jnp.asarray(short)[None], jnp.asarray([6400]))
    padded = np.zeros((2, 12800), np.float32)
    padded[0, :6400] = short
    padded[1] = (rng.standard_normal(12800) * 2000).astype(np.float32)
    ids2, n2 = fn.forward_ctc(params, TINY, jnp.asarray(padded), jnp.asarray([6400, 12800]))
    assert int(n1[0]) == int(n2[0])
    k = int(n1[0])
    np.testing.assert_array_equal(np.asarray(ids1)[0, :k], np.asarray(ids2)[0, :k])


def test_speech_token_len_convention():
    params = fn.init_params(TINY, jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal((1, 16000)) * 2000).astype(np.float32)
    toks, speech_len = fn.audio_embeds(params, TINY, jnp.asarray(audio), jnp.asarray([16000]))
    frames = (16000 - 400) // 160 + 1  # 98
    assert int(speech_len[0]) == -(-frames // 48)  # ceil(frames / 48)
    assert toks.shape[-1] == TINY.adaptor_hidden


def test_forward_llm_pipeline():
    hf_cfg = transformers.Qwen3Config(
        vocab_size=120, hidden_size=48, intermediate_size=64, num_hidden_layers=1,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        rope_theta=10000.0, tie_word_embeddings=True,
    )
    torch.manual_seed(0)
    model = transformers.Qwen3ForCausalLM(hf_cfg).eval()
    lcfg = config_from_hf(hf_cfg)
    llm_params = params_from_state_dict(model.state_dict(), lcfg)
    cfg = fn.FunAsrNanoConfig(**{**TINY.__dict__, "llm": lcfg, "eot_id": -1})
    params = fn.init_params(cfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(2)
    audio = (rng.standard_normal((1, 16000)) * 2000).astype(np.float32)
    prompt_ids = {
        "head": jnp.asarray([[1, 2]], jnp.int32),
        "query": jnp.asarray([[3]], jnp.int32),
        "tail": jnp.asarray([[4, 5]], jnp.int32),
    }
    dc = DecodeConfig(max_new_tokens=5, eot_id=-1, strategy="greedy")
    tokens, counts, valid = fn.forward_llm(
        params, llm_params, cfg, jnp.asarray(audio), jnp.asarray([16000]), prompt_ids, dc
    )
    assert int(counts[0]) >= 1
    # Generated ids start at the static prompt-buffer length (left-padded
    # lockstep decode): t_max = lf + max_new + 1.
    v = int(valid[0])
    assert v == tokens.shape[1] - dc.max_new_tokens - 1
    gen = np.asarray(tokens)[0, v : v + int(counts[0])]
    assert ((gen >= 0) & (gen < lcfg.vocab_size)).all()
