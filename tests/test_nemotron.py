"""Nemotron offline: causal pre-encode vs torch, chunk mask vs reference
formula, RNN-T greedy semantics, end-to-end jit."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from asr_jax.decode.rnnt import rnnt_greedy
from asr_jax.frontend.nemo_mel import NemoMelConfig
from asr_jax.models import nemotron as nm

TINY = nm.NemotronConfig(
    vocab_size=30, d_model=64, num_layers=2, num_heads=4, ffn_dim=96,
    conv_kernel=5, sub_channels=16, pred_hidden=32, joint_hidden=32,
    prompt_hidden=32, lstm_layers=1, num_prompts=8, left_context=6,
    right_context=3, mel=NemoMelConfig(n_mels=80),
)


def test_pre_encode_matches_torch():
    import torch.nn.functional as F

    params = nm.init_params(TINY, jax.random.PRNGKey(0))
    p = jax.tree.map(np.asarray, params["pre_encode"])
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((1, 40, 80)).astype(np.float32)

    t = lambda a: torch.tensor(a)
    # torch replication of the reference conv chain (NCHW, H=time, W=mel)
    x = t(feats).unsqueeze(1)
    pad0 = 2 + TINY.pre_encode_cache

    def cc(x, w_hwio, b, groups, pad_top):
        w = t(w_hwio).permute(3, 2, 0, 1)  # HWIO -> OIHW
        return F.conv2d(F.pad(x, (2, 1, pad_top, 1)), w, t(b), stride=2, groups=groups)

    ch = TINY.sub_channels
    x = F.relu(cc(x, p["conv0"]["w"], p["conv0"]["b"], 1, pad0))
    x = cc(x, p["dw1"]["w"], p["dw1"]["b"], ch, 2)
    x = F.relu(F.conv2d(x, t(p["pw1"]["w"]).permute(3, 2, 0, 1), t(p["pw1"]["b"])))
    x = cc(x, p["dw2"]["w"], p["dw2"]["b"], ch, 2)
    x = F.relu(F.conv2d(x, t(p["pw2"]["w"]).permute(3, 2, 0, 1), t(p["pw2"]["b"])))
    x = x.transpose(1, 2).flatten(2)
    ref = (x @ t(p["out"]["w"]) + t(p["out"]["b"]))[:, TINY.drop_extra :].numpy()

    ours, valid = nm.pre_encode(params, TINY, jnp.asarray(feats), jnp.asarray([40]))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-4, atol=1e-5)
    assert int(valid[0]) == ref.shape[1]


def test_chunk_mask_matches_reference_formula():
    t, chunk, left, right = 20, 4, 6, 3
    mask = nm._chunk_mask_np(t, chunk, left, right)
    fi = np.arange(t)
    chunk_start = (fi // chunk) * chunk
    for i in range(t):
        for j in range(t):
            valid = (j >= chunk_start[i] - left) and (j <= chunk_start[i] + right)
            assert (mask[i, j] == 0.0) == valid


def test_rnnt_greedy_semantics():
    """Scripted joint (keyed on frame + total emissions, matching the
    device state convention: predictor state advances only on emit) vs a
    python reference loop, incl. the max-symbols cap."""
    t, v, max_h = 5, 4, 12  # vocab 0..2, blank=3
    blank = 3
    rng = np.random.default_rng(7)
    table = rng.integers(0, v, size=(t, max_h)).astype(np.int32)  # includes blanks (=3)
    table[2, :] = 2  # a frame that would emit forever -> exercises the cap
    jtable = jnp.asarray(table)

    def joint(token, h, c, enc_frame):
        f = enc_frame[:, 0].astype(jnp.int32)
        emitted = jnp.clip(h[0, :, 0].astype(jnp.int32), 0, max_h - 1)
        tok = jtable[f[0], emitted[0]]
        logits = jnp.zeros((1, v), jnp.float32).at[0, tok].set(1.0)
        return logits, h + 1, c  # state h counts total emissions

    enc = jnp.asarray(np.arange(t, dtype=np.float32)[None, :, None])
    h0 = jnp.zeros((1, 1, 1))
    toks, counts = rnnt_greedy(
        joint, enc, jnp.asarray([t]), h0, h0, start_token=blank, blank_id=blank,
        max_tokens=12, max_symbols_per_frame=3,
    )
    # python reference with identical state convention
    out, frame, nsym = [], 0, 0
    while frame < t and len(out) < 12:
        tok = int(table[frame, min(len(out), max_h - 1)])
        if tok != blank and nsym < 3:
            out.append(tok)
            nsym += 1
        else:
            frame += 1
            nsym = 0
    assert int(counts[0]) == len(out)
    assert np.asarray(toks)[0, : len(out)].tolist() == out


def test_forward_jit_shapes_and_prompt():
    params = nm.init_params(TINY, jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    audio = (rng.standard_normal((2, 8000)) * 0.1).astype(np.float32)
    toks, counts = nm.forward(
        params, TINY, jnp.asarray(audio), jnp.asarray([8000, 4000]),
        jnp.asarray([0, 5]), max_tokens=24,
    )
    assert toks.shape == (2, 24)
    # different prompt ids must be able to change the output path
    toks2, counts2 = nm.forward(
        params, TINY, jnp.asarray(audio), jnp.asarray([8000, 4000]),
        jnp.asarray([1, 5]), max_tokens=24,
    )
    assert toks.shape == toks2.shape
