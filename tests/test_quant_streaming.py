"""Quantization composes with the streaming sessions (VERDICT r4 #4).

The quant route is exact in the kernels' f32 mode (XLA dequant + matmul),
so a q8 streaming session must emit ids IDENTICAL to the same session
built with explicitly dequantized f32 weights — proving every weight the
streaming step consumes routes through the quant dispatch (a raw
``jnp.dot`` on a QuantizedLinear would crash; a silently-unquantized leaf
would show up as a numerics mismatch here only if it drifted, so the test
also asserts the quantizer actually touched the hot leaves).

Reference parity note: the reference quantizes its streaming graphs
through the same ``Optimize_ONNX_Common.py`` pipeline as offline ones.
"""

import numpy as np
import jax

from asr_jax.quant.quantize import (
    QuantizedLinear,
    dequantize_weight,
    quantize_pytree,
)


def _dequant(params):
    def walk(node):
        if isinstance(node, QuantizedLinear):
            return dequantize_weight(node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            t = [walk(v) for v in node]
            return tuple(t) if isinstance(node, tuple) else t
        return node

    return walk(params)


def _count_quantized(params) -> int:
    n = 0

    def walk(node):
        nonlocal n
        if isinstance(node, QuantizedLinear):
            n += 1
            return
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(params)
    return n


def test_paraformer_streaming_q8_matches_dequantized_f32(quant_mm_f32):
    from asr_jax.models import paraformer as pf
    from asr_jax.runtime.streaming_session import ParaformerStreamingSession
    from asr_jax.streaming import paraformer_online as po

    base = pf.ParaformerConfig(vocab_size=50, hidden=32, num_heads=4,
                               head_dim=8, ffn_dim=48, num_encoders0=1,
                               num_encoders=1, num_decoders=1,
                               num_decoder_ffn=1, fsmn_kernel=5,
                               predictor_kernel=3)
    cfg = po.ParaformerStreamConfig(base=base, chunk_samples=8000)
    params = pf.init_params(base, jax.random.PRNGKey(0))
    q = quantize_pytree(params, bits=8, block=8, min_size=0, refine_iters=0)
    assert _count_quantized(q) >= 8  # qkv/out/ffn per block + decoder + head

    audio = (np.random.default_rng(0).standard_normal(3 * cfg.chunk_samples)
             * 2000).astype(np.float32)
    got = ParaformerStreamingSession(q, cfg).transcribe(audio)
    want = ParaformerStreamingSession(_dequant(q), cfg).transcribe(audio)
    assert got.token_ids == want.token_ids
    assert len(want.token_ids) > 0  # the CIF actually fired


def test_dolphin_streaming_q8_matches_dequantized_f32(quant_mm_f32):
    from asr_jax.models import dolphin as dp
    from asr_jax.runtime.streaming_session import DolphinStreamingSession
    from asr_jax.streaming import dolphin_stream as ds

    base = dp.DolphinConfig(vocab_size=60, d_model=32, enc_layers=2,
                            enc_heads=4, enc_ffn=48, cgmlp_dim=64,
                            csgu_kernel=5, fusion_kernel=3, dec_layers=2,
                            dec_heads=4, dec_ffn=48, sos_id=50, eos_id=51,
                            max_target_positions=24)
    cfg = ds.DolphinStreamConfig(base=base, chunk_frames=8, max_frames=64)
    params = dp.init_params(base, jax.random.PRNGKey(1))
    q = quantize_pytree(params, bits=8, block=8, min_size=0, refine_iters=0)
    assert _count_quantized(q) >= 10
    # depthwise/fusion conv kernels must stay raw (consumed elementwise)
    for blk in q["enc_blocks"]:
        assert not isinstance(blk["cgmlp"]["csgu"]["conv"]["w"], QuantizedLinear)
        assert not isinstance(blk["fusion"]["w"], QuantizedLinear)

    rng = np.random.default_rng(2)
    audio = (rng.standard_normal(2 * cfg.advance_samples + cfg.window_samples)
             * 2000).astype(np.float32)
    got = DolphinStreamingSession(q, cfg).transcribe(audio)
    want = DolphinStreamingSession(_dequant(q), cfg).transcribe(audio)
    assert got.token_ids == want.token_ids


def test_offline_paraformer_q8_predictor_head_routes():
    """The CIF predictor head is tiny but min_size=0 plans quantize it —
    both the offline and streaming alpha paths must dispatch it."""
    import jax.numpy as jnp

    from asr_jax.models import paraformer as pf

    base = pf.ParaformerConfig(vocab_size=50, hidden=32, num_heads=4,
                               head_dim=8, ffn_dim=48, num_encoders0=1,
                               num_encoders=1, num_decoders=1,
                               num_decoder_ffn=1, fsmn_kernel=5,
                               predictor_kernel=3)
    params = pf.init_params(base, jax.random.PRNGKey(3))
    q = quantize_pytree(params, bits=8, block=8, min_size=0, refine_iters=0)
    assert isinstance(q["predictor"]["out"]["w"], QuantizedLinear)
    audio = (np.random.default_rng(3).standard_normal((1, 16000))
             * 2000).astype(np.float32)
    toks, counts = pf.forward(q, base, jnp.asarray(audio),
                              jnp.asarray([16000], np.int32))
    t2, c2 = pf.forward(_dequant(q), base, jnp.asarray(audio),
                        jnp.asarray([16000], np.int32))
    np.testing.assert_array_equal(np.asarray(toks), np.asarray(t2))
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(c2))
