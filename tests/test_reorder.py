"""Channel reordering: exactness (outputs unchanged) and quant-error
improvement (reference analog: ``Whisper/Export_Whisper.py:549-609``)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from asr_jax.quant.quantize import dequantize_weight, quantize_linear
from asr_jax.quant.reorder import channel_reorder_pytree, channel_stat


def _interleaved_scales(rng, d, h):
    """Hidden channels with wildly mixed scales so contiguous blocks are
    bad for RTN until sorted."""
    scales = np.where(np.arange(h) % 2 == 0, 0.01, 10.0)
    return (rng.standard_normal((d, h)) * scales).astype(np.float32)


def test_ffn_w1w2_exactness_and_error_gain():
    rng = np.random.default_rng(0)
    d, h = 64, 256
    params = {"ffn": {
        "w1": jnp.asarray(_interleaved_scales(rng, d, h)),
        "b1": jnp.asarray(rng.standard_normal(h).astype(np.float32)),
        "w2": jnp.asarray(rng.standard_normal((h, d)).astype(np.float32)),
        "b2": jnp.asarray(rng.standard_normal(d).astype(np.float32)),
    }}
    re, n = channel_reorder_pytree(params)
    assert n == 1

    x = jnp.asarray(rng.standard_normal((8, d)).astype(np.float32))

    def ffn(p):
        hdn = jnp.maximum(x @ p["ffn"]["w1"] + p["ffn"]["b1"], 0)
        return hdn @ p["ffn"]["w2"] + p["ffn"]["b2"]

    # fp32 summation-order tolerance only (outputs reach ~1e3 magnitude)
    np.testing.assert_allclose(np.asarray(ffn(re)), np.asarray(ffn(params)),
                               rtol=1e-4, atol=1e-3)

    # per-block scale spread of the hidden axis collapses after sorting
    def spread(w):
        s = np.asarray(channel_stat(w))
        blocks = s.reshape(-1, 64)
        return float(np.mean(blocks.max(1) / np.maximum(blocks.min(1), 1e-9)))

    assert spread(re["ffn"]["w1"]) < spread(params["ffn"]["w1"]) / 10


def test_mlp_fc_and_gated_exactness():
    rng = np.random.default_rng(1)
    d, h = 32, 96
    lin = lambda i, o: {"w": jnp.asarray(rng.standard_normal((i, o)).astype(np.float32)),
                        "b": jnp.asarray(rng.standard_normal(o).astype(np.float32))}
    params = {
        "blocks": [
            {"mlp": {"fc1": lin(d, h), "fc2": lin(h, d)}},
            {"mlp": {"gate": lin(d, h), "up": lin(d, h), "down": lin(h, d)}},
        ]
    }
    re, n = channel_reorder_pytree(params, stat="rms")
    assert n == 2
    x = jnp.asarray(rng.standard_normal((4, d)).astype(np.float32))

    def fc(p):
        m = p["blocks"][0]["mlp"]
        return jax.nn.gelu(x @ m["fc1"]["w"] + m["fc1"]["b"]) @ m["fc2"]["w"] + m["fc2"]["b"]

    def gated(p):
        m = p["blocks"][1]["mlp"]
        g = jax.nn.silu(x @ m["gate"]["w"] + m["gate"]["b"])
        u = x @ m["up"]["w"] + m["up"]["b"]
        return (g * u) @ m["down"]["w"] + m["down"]["b"]

    np.testing.assert_allclose(np.asarray(fc(re)), np.asarray(fc(params)), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(gated(re)), np.asarray(gated(params)), rtol=2e-5, atol=2e-5)


def test_reorder_preserves_small_channels_under_quantization():
    """The point of the reordering: in a mixed block the per-column scale is
    set by the large channels, so small-magnitude hidden channels of w2
    round to the zero code (~100% relative error). Sorted, they share a
    block with peers and get a fine scale of their own."""
    rng = np.random.default_rng(2)
    d, h = 64, 512
    w1 = _interleaved_scales(rng, d, h)
    w2 = (rng.standard_normal((h, d)) * np.where(np.arange(h) % 2 == 0, 0.01, 10.0)[:, None]).astype(np.float32)
    params = {"ffn": {"w1": jnp.asarray(w1), "b1": jnp.zeros((h,), jnp.float32),
                      "w2": jnp.asarray(w2), "b2": jnp.zeros((d,), jnp.float32)}}
    re, _ = channel_reorder_pytree(params)

    def row_rel_err(w):
        w = jnp.asarray(w)
        deq = np.asarray(dequantize_weight(quantize_linear(w, bits=4, block=128)))
        w = np.asarray(w)
        return np.linalg.norm(w - deq, axis=1) / np.linalg.norm(w, axis=1)

    # plain: small rows (even indices) are annihilated by the shared scale
    plain = row_rel_err(params["ffn"]["w2"])
    assert np.median(plain[0::2]) > 0.5
    # reordered: small rows now live in small-only blocks and survive
    sorted_err = row_rel_err(re["ffn"]["w2"])
    small_rows = sorted_err[: h // 2]  # perm puts the 0.01-scale rows first
    # 4-bit RTN floor is ~10% relative; the pre-reorder value was 100%.
    assert np.median(small_rows) < 0.2
    np.testing.assert_allclose(
        np.asarray(re["ffn"]["w2"])[: h // 2].std(), 0.01, rtol=0.2)


def test_bad_stat_fails():
    with pytest.raises(ValueError):
        channel_reorder_pytree({}, stat="magic")
