"""Qwen3-ASR: decoder parity vs HF Qwen3ForCausalLM (prefill + greedy with
KV cache, token-for-token), audio-token length formula, prompt assembly,
full pipeline jit."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from asr_jax.decode.ar import DecodeConfig
from asr_jax.layers import qwen3
from asr_jax.loaders.qwen3_hf import config_from_hf, params_from_state_dict
from asr_jax.models import qwen_asr as qa


@pytest.fixture(scope="module")
def tiny_llm():
    hf_cfg = transformers.Qwen3Config(
        vocab_size=120, hidden_size=48, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        rope_theta=10000.0, tie_word_embeddings=True, max_position_embeddings=128,
    )
    torch.manual_seed(0)
    model = transformers.Qwen3ForCausalLM(hf_cfg).eval()
    cfg = config_from_hf(hf_cfg)
    params = params_from_state_dict(model.state_dict(), cfg)
    return model, cfg, params


def test_prefill_logits_match_hf(tiny_llm):
    model, cfg, params = tiny_llm
    ids = np.array([[3, 17, 42, 99, 7]], np.int64)
    with torch.no_grad():
        ref = model(input_ids=torch.tensor(ids)).logits.numpy()
    embeds = params["embed"][jnp.asarray(ids)]
    t_max = 16
    state = qwen3.make_kv_state(cfg, 1, t_max)
    bias = qwen3.causal_prefill_bias(jnp.asarray([5]), ids.shape[1], t_max)
    hidden, _ = qwen3.decoder_pass(params, cfg, embeds, state, jnp.asarray(0, jnp.int32), bias)
    ours = np.asarray(qwen3.logits_from_hidden(params, cfg, hidden))
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=2e-4)


def test_greedy_decode_matches_hf(tiny_llm):
    model, cfg, params = tiny_llm
    prompt = np.array([[5, 30, 77]], np.int64)
    steps = 12
    with torch.no_grad():
        cur, past, out_ref = torch.tensor(prompt), None, []
        for _ in range(steps):
            o = model(input_ids=cur, past_key_values=past, use_cache=True)
            past = o.past_key_values
            nxt = o.logits[:, -1].argmax(-1)
            out_ref.append(int(nxt[0]))
            cur = nxt[:, None]

    embeds = params["embed"][jnp.asarray(prompt)]
    dc = DecodeConfig(max_new_tokens=steps, eot_id=-1, strategy="greedy")
    qcfg = qa.QwenAsrConfig(llm=cfg)
    tokens, counts, _ = qa.transcribe_embeds(params, qcfg, embeds, jnp.asarray([3]), dc)
    ours = np.asarray(tokens)[0, 3 : 3 + steps].tolist()
    assert ours == out_ref


def test_padded_prompt_matches_exact(tiny_llm):
    """A prompt embedded in a longer padded buffer (dynamic valid_len) must
    decode identically to the exact-length prompt."""
    model, cfg, params = tiny_llm
    prompt = np.array([[5, 30, 77, 11]], np.int64)
    embeds = params["embed"][jnp.asarray(prompt)]
    dc = DecodeConfig(max_new_tokens=6, eot_id=-1, strategy="greedy")
    qcfg = qa.QwenAsrConfig(llm=cfg)
    t1, c1, p1 = qa.transcribe_embeds(params, qcfg, embeds, jnp.asarray([4]), dc)
    padded = jnp.concatenate([embeds, jnp.zeros((1, 3, embeds.shape[-1]))], axis=1)
    t2, c2, p2 = qa.transcribe_embeds(params, qcfg, padded, jnp.asarray([4]), dc)
    v1, v2 = int(p1[0]), int(p2[0])
    np.testing.assert_array_equal(np.asarray(t1)[0, v1:v1 + 6], np.asarray(t2)[0, v2:v2 + 6])


def test_batched_unequal_prompt_lengths_match_single(tiny_llm):
    """Two rows with DIFFERENT valid prompt lengths in one batched decode
    must produce exactly what each row produces decoded alone (the
    left-padded lockstep layout; regression for the valid_len[0] bug)."""
    model, cfg, params = tiny_llm
    dc = DecodeConfig(max_new_tokens=5, eot_id=-1, strategy="greedy")
    qcfg = qa.QwenAsrConfig(llm=cfg)
    # THREE rows (B != GQA group count): a malformed bias that lands on the
    # group axis instead of the batch axis cannot broadcast silently.
    rows = [
        (np.array([[5, 30, 77, 11, 42, 7]], np.int64), 6),
        (np.array([[9, 3, 88, 0, 0, 0]], np.int64), 3),
        (np.array([[14, 2, 61, 33, 0, 0]], np.int64), 4),
    ]
    singles = []
    for ids, v in rows:
        emb = params["embed"][jnp.asarray(ids)]
        ts, cs, ps = qa.transcribe_embeds(params, qcfg, emb, jnp.asarray([v]), dc)
        singles.append(np.asarray(ts)[0, int(ps[0]):int(ps[0]) + 5])
    batch = jnp.concatenate([params["embed"][jnp.asarray(ids)] for ids, _ in rows], axis=0)
    t, c, p = qa.transcribe_embeds(
        params, qcfg, batch, jnp.asarray([v for _, v in rows]), dc)
    v = int(p[0])
    for i, want in enumerate(singles):
        np.testing.assert_array_equal(np.asarray(t)[i, v:v + 5], want)


def test_feat_output_len_formula():
    def naive(n):
        leave = n % 100
        f = max(leave - 1, 0) // 2 + 1 if leave > 0 else 0
        if f > 0:
            f = max(f - 1, 0) // 2 + 1
        if f > 0:
            f = max(f - 1, 0) // 2 + 1
        return f + (n // 100) * 13

    for n in [0, 1, 7, 99, 100, 101, 250, 800, 801]:
        assert int(qa.feat_output_len(jnp.asarray(n))) == naive(n), n


def test_assemble_prompt_compacts_audio():
    h = jnp.ones((1, 2, 4)) * 1
    q = jnp.ones((1, 1, 4)) * 2
    s = jnp.ones((1, 1, 4)) * 3
    audio = jnp.broadcast_to(jnp.arange(5, dtype=jnp.float32)[None, :, None], (1, 5, 4)) + 10
    tail = jnp.ones((1, 2, 4)) * 7
    embeds, valid = qa.assemble_prompt(h, q, s, audio, jnp.asarray([3]), tail)
    assert int(valid[0]) == 2 + 1 + 1 + 3 + 2
    row = np.asarray(embeds)[0, :, 0]
    np.testing.assert_array_equal(row[:9], [1, 1, 2, 3, 10, 11, 12, 7, 7])


def test_full_pipeline_jit(tiny_llm):
    model, cfg, params_llm = tiny_llm
    qcfg = qa.QwenAsrConfig(
        n_mels=16, tower_dim=32, tower_layers=1, tower_heads=4, tower_ffn=48,
        downsample_hidden=8, chunks_per_window=2, output_dim=cfg.hidden, llm=cfg, eot_id=-1,
    )
    tower = qa.init_tower_params(qcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((1, 48000)) * 0.1).astype(np.float32)
    prompt_ids = {
        "head": jnp.asarray([[1, 2]], jnp.int32),
        "query": jnp.asarray([[3]], jnp.int32),
        "suffix": jnp.asarray([[4]], jnp.int32),
        "tail": jnp.asarray([[5, 6]], jnp.int32),
    }
    dc = DecodeConfig(max_new_tokens=5, eot_id=-1, strategy="greedy")
    tokens, counts, valid = qa.forward(
        tower, params_llm, qcfg, jnp.asarray(audio), jnp.asarray([48000]), prompt_ids, dc
    )
    assert int(counts[0]) >= 1
    v = int(valid[0])
    gen = np.asarray(tokens)[0, v : v + int(counts[0])]
    assert ((gen >= 0) & (gen < cfg.vocab_size)).all()


def test_language_prompt_and_output_parsing():
    from asr_jax.runtime.qwen_session import QwenAsrSession, QwenPromptTemplate, parse_asr_output

    assert parse_asr_output("language English<asr_text>hello world") == ("English", "hello world")
    assert parse_asr_output("hello") == ("", "hello")
    assert parse_asr_output("language zh<asr_text>你好", user_language="zh") == ("zh", "language zh<asr_text>你好")
    assert parse_asr_output("") == ("", "")

    class _Tok:
        def encode(self, text):
            return [9, 9]

        def decode(self, ids):
            return "language English<asr_text>ok"

    sess = QwenAsrSession(
        None, None, qa.QwenAsrConfig(), tokenizer=_Tok(),
        template=QwenPromptTemplate(head_ids=(1,), suffix_ids=(2,), tail_ids=(3, 4)),
        language_prompt_ids={"en": [50, 51], "zh": [60, 61]},
    )
    ids = sess._prompt_ids("", language="en")
    assert ids["tail"].tolist() == [[3, 4, 50, 51]]
    ids = sess._prompt_ids("", language=None)
    assert ids["tail"].tolist() == [[3, 4]]
    import pytest as _pytest

    with _pytest.raises(KeyError):
        sess._prompt_ids("", language="fr")


def test_fuse_params_matches_unfused():
    """qkv / gate+up fusion (7 -> 4 matmuls per layer) preserves decoder
    outputs for raw AND block-quantized weights (column concat is exact;
    only float summation order differs), and QwenAsrSession applies it by
    default."""
    import numpy as np

    from asr_jax.layers import qwen3
    from asr_jax.quant.quantize import quantize_pytree

    cfg = qwen3.Qwen3Config(vocab_size=96, hidden=32, num_layers=2, num_heads=4,
                            num_kv_heads=2, head_dim=8, ffn_dim=48,
                            attention_bias=True)
    params = qwen3.init_params(cfg, jax.random.PRNGKey(0))
    ids = jnp.asarray(np.random.default_rng(0).integers(0, 96, (2, 5)))

    def run(p, c=cfg):
        embeds = p["embed"][ids]
        state = qwen3.make_kv_state(c, 2, 10)
        bias = qwen3.causal_prefill_bias(jnp.asarray([5, 5]), 5, 10)
        h, _ = qwen3.decoder_pass(p, c, embeds, state, jnp.asarray(0, jnp.int32), bias)
        return np.asarray(qwen3.logits_from_hidden(p, c, h))

    fused = qwen3.fuse_params(params, cfg)
    assert "qkv" in fused["layers"][0]["attn"] and "q" not in fused["layers"][0]["attn"]
    assert "gateup" in fused["layers"][0]["mlp"]
    np.testing.assert_allclose(run(fused), run(params), rtol=2e-5, atol=2e-6)

    qcfg = qwen3.Qwen3Config(vocab_size=96, hidden=128, num_layers=1, num_heads=4,
                             num_kv_heads=2, head_dim=32, ffn_dim=256)
    qp = quantize_pytree(qwen3.init_params(qcfg, jax.random.PRNGKey(1)),
                         bits=4, block=64, pack=True)
    fq = qwen3.fuse_params(qp, qcfg)
    assert "qkv" in fq["layers"][0]["attn"]
    ids_q = jnp.asarray(np.random.default_rng(1).integers(0, 96, (2, 5)))

    def run_q(p):
        embeds = p["embed"][ids_q]
        state = qwen3.make_kv_state(qcfg, 2, 10)
        bias = qwen3.causal_prefill_bias(jnp.asarray([5, 5]), 5, 10)
        h, _ = qwen3.decoder_pass(p, qcfg, embeds, state, jnp.asarray(0, jnp.int32), bias)
        return np.asarray(qwen3.logits_from_hidden(p, qcfg, h))

    np.testing.assert_allclose(run_q(fq), run_q(qp), rtol=2e-5, atol=2e-6)
