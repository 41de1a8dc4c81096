"""Paraformer: CIF vs float64 numpy reference, compensated cumsum accuracy,
decoder block vs independent torch impl, padded-batch invariance."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from asr_jax.decode.cif import cif_fire, compensated_cumsum
from asr_jax.models import paraformer as pf

TINY = pf.ParaformerConfig(
    vocab_size=50, hidden=32, num_heads=4, head_dim=8, ffn_dim=48,
    num_encoders0=1, num_encoders=2, num_decoders=2, num_decoder_ffn=1,
    fsmn_kernel=5, predictor_kernel=3,
)


def naive_cif(alphas, hidden, tail):
    """Float64 integrate-and-fire, faithful to FunASR CifPredictorV2."""
    alphas = np.concatenate([alphas.astype(np.float64), [tail]])
    hidden = np.concatenate([hidden.astype(np.float64), np.zeros((1, hidden.shape[1]))], 0)
    prefix = np.cumsum(alphas)
    floor = np.floor(prefix.astype(np.float32).astype(np.float64))
    prev = np.concatenate([[0.0], floor[:-1]])
    fires = np.nonzero(floor > prev)[0]
    wsum = np.cumsum(alphas[:, None] * hidden, axis=0)
    completed = wsum[fires] - (prefix - floor)[fires, None] * hidden[fires]
    completed = np.concatenate([np.zeros((1, hidden.shape[1])), completed], 0)
    embeds = completed[1:] - completed[:-1]
    return embeds.astype(np.float32), int(floor[-1])


def test_compensated_cumsum_accuracy():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, size=4000).astype(np.float32)
    ours = np.asarray(compensated_cumsum(jnp.asarray(x)))
    exact = np.cumsum(x.astype(np.float64))
    plain = np.cumsum(x)
    assert np.abs(ours - exact).max() < 1e-4
    # and strictly better than the plain f32 cumsum
    assert np.abs(ours - exact).max() <= np.abs(plain - exact).max()


def test_cif_fire_matches_naive():
    rng = np.random.default_rng(1)
    t, d = 40, 8
    alphas = rng.uniform(0, 0.9, size=(1, t)).astype(np.float32)
    hidden = rng.standard_normal((1, t, d)).astype(np.float32)
    embeds, counts = cif_fire(
        jnp.asarray(alphas), jnp.asarray(hidden), jnp.asarray([t]), max_tokens=32, tail_threshold=0.45
    )
    ref_embeds, ref_n = naive_cif(alphas[0], hidden[0], 0.45)
    assert int(counts[0]) == ref_n
    np.testing.assert_allclose(np.asarray(embeds)[0, :ref_n], ref_embeds[:ref_n], rtol=1e-4, atol=1e-5)


def test_cif_fire_respects_valid_len():
    rng = np.random.default_rng(2)
    t, d, valid = 30, 4, 17
    alphas = rng.uniform(0, 0.9, size=(1, t)).astype(np.float32)
    hidden = rng.standard_normal((1, t, d)).astype(np.float32)
    e1, c1 = cif_fire(jnp.asarray(alphas), jnp.asarray(hidden), jnp.asarray([valid]), 16, 0.45)
    e2, c2 = cif_fire(
        jnp.asarray(alphas[:, :valid]), jnp.asarray(hidden[:, :valid]), jnp.asarray([valid]), 16, 0.45
    )
    assert int(c1[0]) == int(c2[0])
    np.testing.assert_allclose(np.asarray(e1), np.asarray(e2), atol=1e-5)


def torch_decoder_block(x, mem, p):
    import torch
    import torch.nn.functional as F

    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
    x, mem = t(x), t(mem)
    nh, hd = TINY.num_heads, TINY.head_dim

    def ln(v, n):
        return F.layer_norm(v, (v.shape[-1],), t(n["scale"]), t(n["bias"]))

    def ffn(v, q):
        h = torch.relu(v @ t(q["w1"]["w"]) + t(q["w1"]["b"]))
        h = ln(h, q["norm"])
        return h @ t(q["w2"]["w"]) + t(q["w2"]["b"])

    y = ffn(ln(x, p["norm1"]), p["ffn"])
    sa = ln(y, p["norm2"])
    w = t(p["fsmn_w"])
    conv = F.conv1d(sa.transpose(1, 2), w.T.unsqueeze(1), padding=2, groups=TINY.hidden).transpose(1, 2)
    x2 = x + conv + sa
    c = ln(x2, p["norm3"])
    B, N = c.shape[0], c.shape[1]
    q = (c @ t(p["cross"]["q"]["w"]) + t(p["cross"]["q"]["b"])).reshape(B, N, nh, hd).permute(0, 2, 1, 3)
    kv = mem @ t(p["cross"]["kv"]["w"]) + t(p["cross"]["kv"]["b"])
    k, v = kv.split(TINY.hidden, dim=-1)
    k = k.reshape(B, -1, nh, hd).permute(0, 2, 1, 3)
    v = v.reshape(B, -1, nh, hd).permute(0, 2, 1, 3)
    att = torch.softmax(q @ k.transpose(-2, -1) / hd**0.5, -1) @ v
    ctx = att.permute(0, 2, 1, 3).reshape(B, N, TINY.hidden)
    return (x2 + ctx @ t(p["cross"]["out"]["w"]) + t(p["cross"]["out"]["b"])).numpy()


def test_decoder_block_matches_torch():
    params = pf.init_params(TINY, jax.random.PRNGKey(0))
    p = jax.tree.map(np.asarray, params["decoders"][0])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, TINY.hidden)).astype(np.float32)
    mem = rng.standard_normal((2, 11, TINY.hidden)).astype(np.float32)

    one = pf.ParaformerConfig(**{**TINY.__dict__, "num_decoders": 1, "num_decoder_ffn": 0})
    params_one = dict(params)
    params_one["decoders"] = [params["decoders"][0]]
    params_one["decoder_ffn"] = []
    # Bypass output head by identity-like check: run decode_tokens minus head
    counts = jnp.asarray([6, 6])
    mem_valid = jnp.asarray([11, 11])
    logits = pf.decode_tokens(params_one, one, jnp.asarray(x), counts, jnp.asarray(mem), mem_valid)
    # torch path: block + after_norm + output
    ref_block = torch_decoder_block(x, mem, p)
    import torch
    import torch.nn.functional as F

    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
    ref = F.layer_norm(
        torch.tensor(ref_block), (TINY.hidden,),
        t(params["decoder_after_norm"]["scale"]), t(params["decoder_after_norm"]["bias"]),
    )
    ref = (ref @ t(params["output"]["w"]) + t(params["output"]["b"])).numpy()
    np.testing.assert_allclose(np.asarray(logits), ref, rtol=1e-3, atol=1e-4)


def test_forward_shapes_and_padded_invariance():
    params = pf.init_params(TINY, jax.random.PRNGKey(1))
    rng = np.random.default_rng(4)
    short = (rng.standard_normal(4800) * 2000).astype(np.float32)

    ids1, n1 = pf.forward(params, TINY, jnp.asarray(short)[None], jnp.asarray([4800]), max_tokens=16)
    padded = np.zeros((2, 9600), np.float32)
    padded[0, :4800] = short
    padded[1] = (rng.standard_normal(9600) * 2000).astype(np.float32)
    ids2, n2 = pf.forward(params, TINY, jnp.asarray(padded), jnp.asarray([4800, 9600]), max_tokens=16)
    assert int(n1[0]) == int(n2[0])
    k = int(n1[0])
    np.testing.assert_array_equal(np.asarray(ids1)[0, :k], np.asarray(ids2)[0, :k])
    assert ids2.shape == (2, 16)
