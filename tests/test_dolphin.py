"""Dolphin: E-Branchformer block vs independent torch impl, espnet mel
conventions, CTC head, probe-aware transcribe jit."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from asr_jax.decode.ar import DecodeConfig
from asr_jax.frontend.espnet_mel import EspnetMelConfig, log_mel
from asr_jax.layers.ebranchformer import ebranchformer_block, init_block_params
from asr_jax.models import dolphin as dp

TINY = dp.DolphinConfig(
    vocab_size=80, d_model=32, enc_layers=2, enc_heads=4, enc_ffn=48,
    cgmlp_dim=64, csgu_kernel=7, fusion_kernel=3, dec_layers=2, dec_heads=4,
    dec_ffn=48, sos_id=70, eos_id=71, language_token_start=40,
    language_token_end=50, region_token_start=50, region_token_end=60,
    max_target_positions=24,
)


def torch_ebranchformer_block(x, p, heads):
    import torch.nn.functional as F

    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
    x = t(x)
    d = x.shape[-1]
    hd = d // heads

    def ln(v, n, w=None):
        w = n["scale"] if w is None else w
        return F.layer_norm(v, (v.shape[-1],), t(n["scale"]), t(n["bias"]))

    def ffn(v, q):
        y = ln(v, q["norm"])
        y = y @ t(q["w1"]["w"]) + t(q["w1"]["b"])
        y = y * torch.sigmoid(y)
        return y @ t(q["w2"]["w"]) + t(q["w2"]["b"])

    x = x + 0.5 * ffn(x, p["ffn_macaron"])
    B, S = x.shape[0], x.shape[1]
    # attention branch with rel-pos
    y = ln(x, p["norm_mha"])
    q = (y @ t(p["attn"]["q"]["w"]) + t(p["attn"]["q"]["b"])).reshape(B, S, heads, hd).permute(0, 2, 1, 3)
    k = (y @ t(p["attn"]["k"]["w"]) + t(p["attn"]["k"]["b"])).reshape(B, S, heads, hd).permute(0, 2, 1, 3)
    v = (y @ t(p["attn"]["v"]["w"]) + t(p["attn"]["v"]["b"])).reshape(B, S, heads, hd).permute(0, 2, 1, 3)
    from asr_jax.layers.conformer import relative_position_embedding

    pe = t(relative_position_embedding(S, d))
    rel_k = (pe @ t(p["attn"]["rel_k"]["w"])).reshape(-1, heads, hd)
    qu = q + t(p["attn"]["bias_u"]).unsqueeze(1)
    qv = q + t(p["attn"]["bias_v"]).unsqueeze(1)
    ac = qu @ k.transpose(-2, -1)
    bd = torch.einsum("bhsd,phd->bhsp", qv, rel_k)
    # torch rel shift
    bpad = F.pad(bd, (1, 0))
    bpad = bpad.view(B, heads, 2 * S, S)[:, :, 1:].reshape(B, heads, S, 2 * S - 1)
    bd = bpad[..., :S]
    att = torch.softmax((ac + bd) / hd**0.5, -1) @ v
    x1 = att.permute(0, 2, 1, 3).reshape(B, S, d) @ t(p["attn"]["o"]["w"]) + t(p["attn"]["o"]["b"])
    # cgMLP branch
    y2 = ln(x, p["norm_mlp"])
    g0 = F.gelu(y2 @ t(p["cgmlp"]["proj1"]["w"]) + t(p["cgmlp"]["proj1"]["b"]))
    r, g = g0.split(g0.shape[-1] // 2, dim=-1)
    g = ln(g, p["cgmlp"]["csgu"]["norm"])
    w = t(p["cgmlp"]["csgu"]["conv"]["w"])
    g = F.conv1d(g.transpose(1, 2), w.T.unsqueeze(1), padding=(w.shape[0] - 1) // 2,
                 groups=g.shape[-1]).transpose(1, 2) + t(p["cgmlp"]["csgu"]["conv"]["b"])
    x2 = (r * g) @ t(p["cgmlp"]["proj2"]["w"]) + t(p["cgmlp"]["proj2"]["b"])
    c = torch.cat([x1, x2], -1)
    wf = t(p["fusion"]["w"])
    fused = F.conv1d(c.transpose(1, 2), wf.T.unsqueeze(1), padding=(wf.shape[0] - 1) // 2,
                     groups=c.shape[-1]).transpose(1, 2) + t(p["fusion"]["b"])
    c = c + fused
    x = x + c @ t(p["merge_proj"]["w"]) + t(p["merge_proj"]["b"])
    x = x + 0.5 * ffn(x, p["ffn"])
    return ln(x, p["norm_final"]).numpy()


def test_ebranchformer_block_matches_torch():
    p = init_block_params(jax.random.PRNGKey(0), 32, 4, 48, 64, 7, 3)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    from asr_jax.layers.conformer import relative_position_embedding

    pe = jnp.asarray(relative_position_embedding(9, 32))
    ours = np.asarray(ebranchformer_block(jnp.asarray(x), p, 4, pe, None, None))
    ref = torch_ebranchformer_block(x, jax.tree.map(np.asarray, p), 4)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


def test_espnet_mel_keeps_trailing_frame():
    cfg = EspnetMelConfig()
    audio = jnp.zeros((1, 16000))
    mel = log_mel(audio, cfg)
    assert mel.shape[1] == 16000 // 160 + 1
    # silence -> log(1e-10) floor
    np.testing.assert_allclose(np.asarray(mel), np.log(1e-10), atol=1e-4)


def test_ctc_head_and_encoder_shapes():
    params = dp.init_params(TINY, jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    audio = (rng.standard_normal((2, 8000)) * 0.1).astype(np.float32)
    enc, valid = dp.encode(params, TINY, jnp.asarray(audio), jnp.asarray([8000, 4000]))
    assert enc.shape[0] == 2 and enc.shape[2] == TINY.d_model
    ids, counts = dp.ctc_decode(params, TINY, enc, valid)
    assert ids.shape[0] == 2 and counts.shape == (2,)


def test_transcribe_probe_and_decode():
    params = dp.init_params(TINY, jax.random.PRNGKey(2))
    rng = np.random.default_rng(2)
    audio = (rng.standard_normal((1, 8000)) * 0.1).astype(np.float32)
    prompt = np.array([[TINY.sos_id, -1, -2, 75, 76]], np.int32)
    dc = DecodeConfig(max_new_tokens=6, eot_id=TINY.eos_id, strategy="greedy")
    out = dp.transcribe(params, TINY, jnp.asarray(audio), jnp.asarray([8000]), jnp.asarray(prompt), dc)
    lang = int(out["language"][0])
    region = int(out["region"][0])
    assert 40 <= lang < 50 and 50 <= region < 60
    assert out["tokens"].shape[0] == 1
    toks = np.asarray(out["tokens"])[0]
    assert toks[1] == lang and toks[2] == region  # -1/-2 slots replaced
