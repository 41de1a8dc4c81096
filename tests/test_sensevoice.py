"""SenseVoice model: SANM block vs independent torch impl, CTC collapse,
padded-batch invariance, end-to-end jit."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from asr_jax.decode.ctc import ctc_greedy_collapse
from asr_jax.layers.sanm import depthwise_conv1d_time, sanm_block
from asr_jax.models import sensevoice as sv

TINY = sv.SenseVoiceConfig(
    vocab_size=64,
    hidden=32,
    num_heads=4,
    head_dim=8,
    ffn_dim=48,
    num_encoders0=1,
    num_encoders=2,
    num_tp_encoders=1,
    fsmn_kernel=5,
)


def torch_sanm_block(x, p, num_heads, head_dim, residual):
    """Independent torch implementation of the SANM block (unfolded math)."""
    import torch
    import torch.nn.functional as F

    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
    x = t(x)
    hidden = num_heads * head_dim
    y = F.layer_norm(x, (x.shape[-1],), t(p["norm1"]["scale"]), t(p["norm1"]["bias"]))
    qkv = y @ t(p["qkv"]["w"]) + t(p["qkv"]["b"])
    q, k, v = qkv.split(hidden, dim=-1)
    B, T = x.shape[0], x.shape[1]
    qh = q.reshape(B, T, num_heads, head_dim).permute(0, 2, 1, 3)
    kh = k.reshape(B, T, num_heads, head_dim).permute(0, 2, 1, 3)
    vh = v.reshape(B, T, num_heads, head_dim).permute(0, 2, 1, 3)
    att = torch.softmax(qh @ kh.transpose(-2, -1) / head_dim**0.5, dim=-1) @ vh
    ctx = att.permute(0, 2, 1, 3).reshape(B, T, hidden)
    # FSMN: depthwise conv over time with symmetric zero pad, + v residual
    w = t(p["fsmn_w"])  # (K, C)
    conv_w = w.T.unsqueeze(1)  # (C, 1, K)
    pad = (w.shape[0] - 1) // 2
    mem = F.conv1d(v.transpose(1, 2), conv_w, padding=pad, groups=hidden).transpose(1, 2) + v
    branch = ctx @ t(p["out"]["w"]) + t(p["out"]["b"]) + mem
    a = branch + x if residual else branch
    y2 = F.layer_norm(a, (hidden,), t(p["norm2"]["scale"]), t(p["norm2"]["bias"]))
    h = torch.relu(y2 @ t(p["ffn"]["w1"]) + t(p["ffn"]["b1"]))
    out = a + h @ t(p["ffn"]["w2"]) + t(p["ffn"]["b2"])
    return out.numpy()


def test_depthwise_conv_matches_torch():
    import torch
    import torch.nn.functional as F

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 13, 6)).astype(np.float32)
    w = rng.standard_normal((5, 6)).astype(np.float32)
    ours = np.asarray(depthwise_conv1d_time(jnp.asarray(x), jnp.asarray(w), 2, 2))
    ref = F.conv1d(
        torch.tensor(x).transpose(1, 2),
        torch.tensor(w.T).unsqueeze(1),
        padding=2,
        groups=6,
    ).transpose(1, 2).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("residual", [True, False])
def test_sanm_block_matches_torch(residual):
    rng = jax.random.PRNGKey(0)
    params = sv.init_params(TINY, rng)
    p = params["encoders"][0]
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 9, TINY.hidden))
    ours = np.asarray(
        sanm_block(x, p, TINY.num_heads, TINY.head_dim, None, None, residual=residual)
    )
    ref = torch_sanm_block(np.asarray(x), jax.tree.map(np.asarray, p), TINY.num_heads, TINY.head_dim, residual)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)


def test_ctc_greedy_collapse():
    ids = jnp.asarray([[0, 5, 5, 0, 3, 3, 3, 7, 0, 9], [2, 2, 2, 2, 0, 0, 0, 0, 0, 0]], jnp.int32)
    valid = jnp.asarray([10, 4], jnp.int32)
    toks, counts = ctc_greedy_collapse(ids, valid, blank_id=0)
    assert counts.tolist() == [4, 1]
    assert toks[0, :4].tolist() == [5, 3, 7, 9]
    assert toks[1, :1].tolist() == [2]


def test_forward_padded_batch_invariance():
    """A short sample padded inside a longer batch must produce the same
    tokens as running it alone at its exact length."""
    cfg = TINY
    params = sv.init_params(cfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(3)
    short = (rng.standard_normal(4800) * 2000).astype(np.float32)

    a_single = jnp.asarray(short)[None]
    toks1, n1 = sv.forward(params, cfg, a_single, jnp.asarray([4800]), jnp.asarray([2]))

    padded = np.zeros((2, 9600), np.float32)
    padded[0, :4800] = short
    padded[1] = (rng.standard_normal(9600) * 2000).astype(np.float32)
    toks2, n2 = sv.forward(
        params, cfg, jnp.asarray(padded), jnp.asarray([4800, 9600]), jnp.asarray([2, 1])
    )
    assert int(n1[0]) == int(n2[0])
    k = int(n1[0])
    np.testing.assert_array_equal(np.asarray(toks1)[0, :k], np.asarray(toks2)[0, :k])


def test_forward_shapes_and_jit():
    cfg = TINY
    params = sv.init_params(cfg, jax.random.PRNGKey(4))
    audio = jnp.zeros((2, 8000))
    toks, n = sv.forward(params, cfg, audio, jnp.asarray([8000, 6000]), jnp.asarray([0, 1]))
    t_frames = cfg.fbank.num_frames(8000)
    t_seq = (t_frames + cfg.lfr_n - 1) // cfg.lfr_n + cfg.prompt_len
    assert toks.shape == (2, t_seq)
    assert n.shape == (2,)
