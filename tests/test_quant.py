"""Quantization: RTN/refined block quantization error, pytree walking,
quantized matmul correctness in both matmul modes, bf16 cast, quantized
model end-to-end."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from asr_jax.layers.transformer import dense
from asr_jax.ops.quant_matmul import _xla_quant_dense, quant_dense, set_quant_config
from asr_jax.quant.quantize import (
    cast_pytree,
    dequantize_weight,
    quantization_error,
    quantize_linear,
    quantize_pytree,
    quantization_error,
)


def test_q8_error_small_and_refine_helps():
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((256, 64)).astype(np.float32))
    q_rtn = quantize_linear(w, bits=8, block=64, refine_iters=0)
    q_ref = quantize_linear(w, bits=8, block=64, refine_iters=3)
    e_rtn = quantization_error(w, q_rtn)
    e_ref = quantization_error(w, q_ref)
    assert e_rtn < 0.01
    assert e_ref <= e_rtn * 1.05  # refinement never materially worse


def test_q4_error_reasonable():
    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.standard_normal((256, 64)).astype(np.float32))
    qleaf = quantize_linear(w, bits=4, block=32, refine_iters=2)
    assert qleaf["q"].dtype == jnp.int8  # centered storage: q - 128
    assert int(qleaf["q"].max()) <= 15 - 128
    assert quantization_error(w, qleaf) < 0.12


def test_quant_dense_matches_dequant_matmul(quant_mm_f32):
    rng = np.random.default_rng(2)
    w = jnp.asarray(rng.standard_normal((128, 96)).astype(np.float32))
    x = jnp.asarray(rng.standard_normal((2, 5, 128)).astype(np.float32))
    qleaf = quantize_linear(w, bits=8, block=64)
    ref = x @ dequantize_weight(qleaf)
    out = quant_dense(x, qleaf)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # dense() consumes quantized leaves transparently
    out2 = dense(x, {"w": qleaf, "b": jnp.zeros((96,))})
    np.testing.assert_allclose(np.asarray(out2), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_quantize_pytree_walks_and_model_runs():
    from asr_jax.models import sensevoice as sv

    cfg = sv.SenseVoiceConfig(
        vocab_size=300, hidden=64, num_heads=4, head_dim=16, ffn_dim=256,
        num_encoders0=1, num_encoders=1, num_tp_encoders=1, fsmn_kernel=5,
    )
    params = sv.init_params(cfg, jax.random.PRNGKey(0))
    qparams = quantize_pytree(params, bits=8, block=64, min_size=4096)
    from asr_jax.quant.quantize import QuantizedLinear

    # ffn weights (64*256 = 16k >= 4096) got quantized
    assert isinstance(qparams["encoders"][0]["ffn"]["w1"], QuantizedLinear)
    assert isinstance(qparams["encoders"][0]["qkv"]["w"], QuantizedLinear)
    x = jnp.ones((1, 3, 64))
    y = dense(x, qparams["encoders"][0]["out"])
    assert y.shape[-1] == 64


def test_cast_pytree_bf16():
    tree = {"a": jnp.ones((4,), jnp.float32), "b": jnp.asarray([1, 2], jnp.int32)}
    out = cast_pytree(tree, jnp.bfloat16)
    assert out["a"].dtype == jnp.bfloat16
    assert out["b"].dtype == jnp.int32


def test_quantized_sensevoice_forward_agrees():
    """A q8-quantized SenseVoice must produce near-identical CTC tokens."""
    from asr_jax.models import sensevoice as sv

    cfg = sv.SenseVoiceConfig(
        vocab_size=300, hidden=64, num_heads=4, head_dim=16, ffn_dim=256,
        num_encoders0=1, num_encoders=2, num_tp_encoders=1, fsmn_kernel=5,
    )
    params = sv.init_params(cfg, jax.random.PRNGKey(5))
    qparams = quantize_pytree(params, bits=8, block=64, min_size=4096)
    rng = np.random.default_rng(5)
    audio = jnp.asarray((rng.standard_normal((1, 8000)) * 2000).astype(np.float32))
    t1, n1 = sv.forward(params, cfg, audio, jnp.asarray([8000]), jnp.asarray([1]))
    t2, n2 = sv.forward(qparams, cfg, audio, jnp.asarray([8000]), jnp.asarray([1]))
    # random weights produce near-uniform logits; require strong agreement
    k = min(int(n1[0]), int(n2[0]))
    agree = (np.asarray(t1)[0, :k] == np.asarray(t2)[0, :k]).mean() if k else 1.0
    assert abs(int(n1[0]) - int(n2[0])) <= max(2, int(0.2 * int(n1[0])))
    assert agree > 0.7


def test_packed_int4_roundtrip_and_matmul(quant_mm_f32):
    from asr_jax.quant.quantize import quantize_linear, dequantize_weight

    rng = np.random.default_rng(9)
    k, n, block = 2048, 256, 128
    w = jnp.asarray(rng.standard_normal((k, n)).astype(np.float32))
    qleaf = quantize_linear(w, bits=4, block=block, pack=True)
    assert qleaf.packed and qleaf["q"].shape == (k // 2, n)
    # packed dequant error comparable to unpacked int4
    unpacked = quantize_linear(w, bits=4, block=block, pack=False)
    e_p = quantization_error(w, qleaf)
    e_u = quantization_error(w, unpacked)
    np.testing.assert_allclose(e_p, e_u, rtol=1e-5)

    x = jnp.asarray(rng.standard_normal((128, k)).astype(np.float32))
    ref = x @ dequantize_weight(qleaf)
    out = _xla_quant_dense(x, qleaf)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_packed_artifact_roundtrip(tmp_path):
    from asr_jax.quant.quantize import quantize_linear, dequantize_weight
    from asr_jax.runtime.artifact import save_model, load_model
    from asr_jax.runtime.metadata import ModelMetadata

    rng = np.random.default_rng(10)
    w = jnp.asarray(rng.standard_normal((256, 64)).astype(np.float32))
    qleaf = quantize_linear(w, bits=4, block=128, pack=True)
    save_model(tmp_path / "m", {"layer": {"w": qleaf}}, ModelMetadata(family="x"))
    loaded, _ = load_model(tmp_path / "m")
    q2 = loaded["layer"]["w"]
    assert q2.packed and q2.bits == 4
    np.testing.assert_allclose(
        np.asarray(dequantize_weight(q2)), np.asarray(dequantize_weight(qleaf)), atol=1e-6
    )


def test_q2_roundtrip_and_pack2(quant_mm_f32):
    from asr_jax.quant.quantize import (
        dequantize_weight, pack2_quarters, quantize_linear, quantization_error,
        unpack2_quarters,
    )

    rng = np.random.default_rng(11)
    k, n, block = 512, 64, 128
    w = jnp.asarray(rng.standard_normal((k, n)).astype(np.float32))

    # pack2/unpack2 bit-exact roundtrip on raw 2-bit codes
    codes = jnp.asarray(rng.integers(0, 4, size=(k, n)).astype(np.uint8))
    packed = pack2_quarters(codes)
    assert packed.shape == (k // 4, n)
    np.testing.assert_array_equal(
        np.asarray(unpack2_quarters(packed)), np.asarray(codes, np.float32)
    )

    # Q2 quantization: coarse but bounded error, packed == unpacked dequant
    qleaf = quantize_linear(w, bits=2, block=block, pack=True)
    assert qleaf.packed and qleaf.bits == 2 and qleaf.q.shape == (k // 4, n)
    e_p = quantization_error(w, qleaf)
    unpacked = quantize_linear(w, bits=2, block=block, pack=False)
    e_u = quantization_error(w, unpacked)
    np.testing.assert_allclose(e_p, e_u, rtol=1e-5)
    # 4 uniform levels over a ~±2.9-sigma block range on gaussian data:
    # step ~1.9 sigma -> relative RMS error ~0.5-0.55.
    assert e_u < 0.6

    # quant_dense consumes the packed-2-bit leaf via the XLA path
    from asr_jax.ops.quant_matmul import quant_dense

    x = jnp.asarray(rng.standard_normal((8, k)).astype(np.float32))
    ref = x @ dequantize_weight(qleaf)
    np.testing.assert_allclose(np.asarray(quant_dense(x, qleaf)),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_kquant_objective_beats_rtn_with_outliers():
    from asr_jax.quant.quantize import dequantize_weight, quantize_linear

    rng = np.random.default_rng(12)
    k, n, block = 512, 64, 128
    w = rng.standard_normal((k, n)).astype(np.float32)
    # Inject sparse outliers: RTN stretches the block range to cover them,
    # wasting resolution on the bulk; kquant may shrink the scale instead.
    mask = rng.random((k, n)) < 0.005
    w = w + mask * rng.standard_normal((k, n)).astype(np.float32) * 12.0
    w = jnp.asarray(w)

    def weighted_err(qleaf):
        deq = dequantize_weight(qleaf)
        imp = np.asarray(w) ** 2
        return float(np.sum(imp * np.asarray(w - deq) ** 2))

    e_rtn = weighted_err(quantize_linear(w, bits=4, block=block, objective="rtn"))
    e_kq = weighted_err(quantize_linear(w, bits=4, block=block, objective="kquant"))
    assert e_kq <= e_rtn * 1.001, (e_kq, e_rtn)


def test_hqq_beats_or_matches_rtn():
    """HQQ zero-point optimization: reconstruction error <= RTN on an
    outlier-heavy weight (the regime HQQ targets)."""
    from asr_jax.quant.quantize import quantization_error, quantize_linear

    rng = np.random.default_rng(0)
    w = rng.standard_normal((256, 64)).astype(np.float32)
    w[rng.integers(0, 256, 40), rng.integers(0, 64, 40)] *= 12.0  # outliers
    w = jnp.asarray(w)
    err_rtn = quantization_error(w, quantize_linear(w, bits=4, block=64))
    err_hqq = quantization_error(w, quantize_linear(w, bits=4, block=64, objective="hqq"))
    assert err_hqq <= err_rtn * 1.02  # never meaningfully worse
    assert err_hqq < 0.5


def test_dynamic_int8_dense_close_to_f32():
    from asr_jax.layers.transformer import dense
    from asr_jax.quant.quantize import quantize_linear

    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.standard_normal((128, 96)).astype(np.float32) * 0.1)
    b = jnp.asarray(rng.standard_normal(96).astype(np.float32) * 0.01)
    x = jnp.asarray(rng.standard_normal((2, 5, 128)).astype(np.float32))
    ref = np.asarray(dense(x, {"w": w, "b": b}))
    qleaf = quantize_linear(w, objective="dynamic")
    assert qleaf.dynamic and qleaf.block == 128 and qleaf.bits == 8
    out = np.asarray(dense(x, {"w": qleaf, "b": b}))
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert rel < 0.02, rel

    # jit-compatible (QuantizedLinear is a pytree node; dynamic is aux).
    out2 = np.asarray(jax.jit(lambda x: dense(x, {"w": qleaf, "b": b}))(x))
    np.testing.assert_allclose(out2, out, rtol=1e-5, atol=1e-6)


def test_quantized_embedding_gather_and_tied_logits():
    from asr_jax.quant.quantize import embedding_logits, quantize_embedding

    rng = np.random.default_rng(2)
    table = jnp.asarray(rng.standard_normal((50, 64)).astype(np.float32))
    qemb = quantize_embedding(table, bits=8, block=32)
    ids = jnp.asarray([[0, 7, 49], [3, 3, 11]])
    got = np.asarray(qemb[ids])
    want = np.asarray(table)[np.asarray(ids)]
    assert got.shape == want.shape
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 0.01, rel

    y = jnp.asarray(rng.standard_normal((2, 64)).astype(np.float32))
    lg = np.asarray(embedding_logits(qemb, y))
    ref = np.asarray(y @ table.T)
    assert np.linalg.norm(lg - ref) / np.linalg.norm(ref) < 0.01


def test_qwen3_runs_with_quantized_embedding():
    """Tied Qwen3 decoder runs with a QuantizedEmbedding for lookup + head,
    and the artifact round trip preserves the leaf."""
    from asr_jax.layers import qwen3
    from asr_jax.quant.quantize import QuantizedEmbedding, quantize_pytree
    from asr_jax.runtime.artifact import flatten_pytree, unflatten_pytree

    cfg = qwen3.Qwen3Config(vocab_size=512, hidden=64, num_layers=1, num_heads=4,
                            num_kv_heads=2, head_dim=16, ffn_dim=96)
    params = qwen3.init_params(cfg, jax.random.PRNGKey(0))
    qparams = quantize_pytree(params, min_size=1 << 10, quantize_embeddings=True)
    assert isinstance(qparams["embed"], QuantizedEmbedding)

    ids = jnp.asarray([[3, 17, 42]])
    embeds = qparams["embed"][ids].astype(jnp.float32)
    state = qwen3.make_kv_state(cfg, 1, 8)
    bias = qwen3.causal_prefill_bias(jnp.asarray([3]), 3, 8)
    hidden, _ = qwen3.decoder_pass(qparams, cfg, embeds, state, jnp.asarray(0, jnp.int32), bias)
    logits = qwen3.logits_from_hidden(qparams, cfg, hidden)
    assert logits.shape == (1, 3, 512)

    rt = unflatten_pytree(flatten_pytree(qparams))
    assert isinstance(rt["embed"], QuantizedEmbedding)
    np.testing.assert_array_equal(np.asarray(rt["embed"].q), np.asarray(qparams["embed"].q))


def test_whisper_runs_with_quantized_embedding():
    """Tied Whisper logits route through embedding_logits, so
    quantize_embeddings artifacts transcribe instead of crashing on .T
    (code-review r2 finding)."""
    from asr_jax.decode.ar import DecodeConfig
    from asr_jax.models import whisper as wh
    from asr_jax.quant.quantize import QuantizedEmbedding, quantize_pytree

    cfg = wh.WhisperConfig(
        vocab_size=256, d_model=32, encoder_layers=1, decoder_layers=1,
        num_heads=4, n_mels=16, max_source_positions=20,
        max_target_positions=16, sot_id=1, eot_id=2, first_language_id=10,
        num_languages=4, transcribe_id=20, translate_id=21,
        no_timestamps_id=22, no_speech_id=30,
    )
    params = wh.init_params(cfg, jax.random.PRNGKey(0))
    qparams = quantize_pytree(params, min_size=1 << 10, quantize_embeddings=True)
    assert isinstance(qparams["decoder"]["embed"], QuantizedEmbedding)
    mel = jnp.zeros((1, 40, 16), jnp.float32)
    out = wh.transcribe_window(
        qparams, cfg, mel, jnp.asarray([[1, -1, 20, 22]], jnp.int32),
        DecodeConfig(max_new_tokens=3, eot_id=2))
    assert out["tokens"].shape[0] == 1


def test_penalty_excludes_prompt_slots():
    """Repetition penalty matches the reference's generated-only save_id:
    prompt slots (incl. zero-filled embed-prompt buffers) are never
    penalized (code-review r2 finding on qwen's zero buffer)."""
    from asr_jax.decode.strategies import apply_repetition_penalty

    logits = jnp.ones((1, 8), jnp.float32)
    buf = jnp.asarray([[0, 0, 0, 5, 6, 0, 0, 0]], jnp.int32)  # prompt=3 zeros, gen=[5,6]
    # Without start: id 0 is phantom-penalized via the zero prompt slots.
    out_bad = np.asarray(apply_repetition_penalty(logits, buf, 5, 2.0, 8))
    assert out_bad[0, 0] == 0.5
    # With hist_start=3 only the generated ids 5 and 6 are penalized.
    out = np.asarray(apply_repetition_penalty(logits, buf, 5, 2.0, 8, hist_start=3))
    assert out[0, 0] == 1.0 and out[0, 5] == 0.5 and out[0, 6] == 0.5
    assert out[0, 1] == 1.0


def test_quantized_embedding_tied_head_paths_agree(quant_mm_f32):
    """The tied-head path through the stored (D, V) copy, the blockwise
    einsum fallback, and dense y @ dequant().T all agree; artifact
    roundtrip rebuilds the transposed copy from the stored flag."""
    import jax.numpy as jnp
    from asr_jax.quant.quantize import quantize_embedding, embedding_logits
    from asr_jax.runtime.artifact import flatten_pytree, unflatten_pytree

    rng = np.random.default_rng(3)
    v, d = 384, 256
    w = jnp.asarray(rng.standard_normal((v, d)).astype(np.float32) * 0.05)
    y = jnp.asarray(rng.standard_normal((2, d)).astype(np.float32))

    emb = quantize_embedding(w, bits=8, block=64)
    v_pad = -(-v // 512) * 512  # head copy pads V to a 512 multiple
    assert emb.q_t is not None and emb.q_t.shape == (d, v_pad)
    assert emb.scale_t.shape == (d // 64, v_pad)
    dense_ref = np.asarray(y @ emb.dequant().T)

    got_tied = np.asarray(embedding_logits(emb, y))          # q_t path (XLA on CPU)
    np.testing.assert_allclose(got_tied, dense_ref, rtol=1e-5, atol=1e-5)

    emb_nt = quantize_embedding(w, bits=8, block=64, tie_head=False)
    got_einsum = np.asarray(embedding_logits(emb_nt, y))     # blockwise fallback
    np.testing.assert_allclose(got_einsum, dense_ref, rtol=1e-4, atol=1e-4)

    back = unflatten_pytree(flatten_pytree({"embed": emb}))["embed"]
    assert back.q_t is not None
    np.testing.assert_array_equal(np.asarray(back.q_t), np.asarray(emb.q_t))
    back_nt = unflatten_pytree(flatten_pytree({"embed": emb_nt}))["embed"]
    assert back_nt.q_t is None


def test_quantized_embedding_tied_head_q4_packs_nibbles(quant_mm_f32):
    """4-bit tied heads store the (D/2, V_pad) NIBBLE-PACKED orientation
    (the head is the largest weight read of a decode step; unpacked int8
    doubles it). Logits must match dense y @ dequant().T to
    quantization-roundoff, through embedding_logits and through the
    quantized matmul on the stored leaf; padded columns give exactly-0
    logits; the artifact roundtrip must rebuild the packed copy
    bit-identically."""
    from asr_jax.quant.quantize import embedding_logits, quantize_embedding
    from asr_jax.runtime.artifact import flatten_pytree, unflatten_pytree

    rng = np.random.default_rng(7)
    v, d = 300, 256
    w = jnp.asarray(rng.standard_normal((v, d)).astype(np.float32) * 0.05)
    y = jnp.asarray(rng.standard_normal((2, d)).astype(np.float32))

    emb = quantize_embedding(w, bits=4, block=128)
    assert emb.q_t_packed
    v_pad = -(-v // 2048) * 2048
    assert emb.q_t.shape == (d // 2, v_pad)
    assert emb.scale_t.shape == (d // 128, v_pad)
    dense_ref = np.asarray(y @ emb.dequant().T)

    got = np.asarray(embedding_logits(emb, y))
    assert got.shape == (2, v)
    np.testing.assert_allclose(got, dense_ref, rtol=1e-5, atol=1e-5)

    leaf = {"q": emb.q_t, "scale": emb.scale_t, "zero": emb.zero_t,
            "bits": 4, "block": 128, "packed": True}
    got_full = np.asarray(_xla_quant_dense(y, leaf))
    assert got_full.shape == (2, v_pad)
    np.testing.assert_allclose(got_full[:, :v], dense_ref, rtol=2e-5, atol=2e-5)
    # padded columns have zero scale -> exactly-0 logits
    np.testing.assert_array_equal(got_full[:, v:], 0.0)

    back = unflatten_pytree(flatten_pytree({"embed": emb}))["embed"]
    assert back.q_t_packed
    np.testing.assert_array_equal(np.asarray(back.q_t), np.asarray(emb.q_t))
    np.testing.assert_array_equal(np.asarray(back.zero_t), np.asarray(emb.zero_t))


@pytest.mark.parametrize("m", [1, 8, 64, 512])
@pytest.mark.parametrize("bits,pack", [(8, False), (4, True), (2, True)],
                         ids=["int8", "packed4", "packed2"])
def test_xla_quant_dense_modes(bits, pack, m):
    """The one quantized-matmul route in both modes against the f32
    dequant reference: f32 mode exact, bf16 mode (one bf16 pass, f32
    accumulation) well inside the quantization error itself."""
    rng = np.random.default_rng(bits * 1000 + m)
    k, n, block = 512, 256, 64
    w = jnp.asarray(rng.standard_normal((k, n)).astype(np.float32) * 0.05)
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32))
    qleaf = quantize_linear(w, bits=bits, block=block, pack=pack)
    assert bool(qleaf["packed"]) == pack
    want = np.asarray(jnp.dot(x, dequantize_weight(qleaf),
                              precision=jax.lax.Precision.HIGHEST))
    exact = np.asarray(x @ w)
    try:
        set_quant_config(mm="f32")
        got32 = np.asarray(_xla_quant_dense(x, qleaf))
        set_quant_config(mm="bf16")
        got16 = np.asarray(_xla_quant_dense(x, qleaf))
    finally:
        set_quant_config(mm=None)
    assert got32.shape == got16.shape == (m, n)
    assert got32.dtype == got16.dtype == np.float32
    np.testing.assert_allclose(got32, want, rtol=2e-5, atol=2e-5)
    # bf16 rounding is ~2^-8 relative per operand; the quantization error
    # (vs the unquantized weight) bounds it from above at every bit width
    quant_err = np.abs(want - exact).max()
    bf16_err = np.abs(got16 - want).max()
    assert bf16_err < 0.5 * quant_err, (bf16_err, quant_err)
    assert bf16_err / (np.abs(want).max() + 1e-6) < 2e-2


def test_quant_mode_is_validated():
    with pytest.raises(ValueError):
        set_quant_config(mm="fp32")
    try:
        set_quant_config(mm="f32")
        assert quant_dense(jnp.ones((1, 128)), quantize_linear(
            jnp.ones((128, 8)), bits=8, block=64)).dtype == jnp.float32
    finally:
        set_quant_config(mm=None)


def test_quantize_pytree_skips_depthwise_conv_kernels():
    """Depthwise conv kernels ({"dw": {"w": (K, C)}}) are consumed
    elementwise, not via dense(); quantize_pytree must leave them raw
    (regression: FireRed q8 crashed with 'attribute name must be string'
    when the dw kernel became a QuantizedLinear)."""
    import jax
    import jax.numpy as jnp
    from asr_jax.models import firered as fr
    from asr_jax.decode.ar import DecodeConfig
    from asr_jax.quant.quantize import QuantizedLinear, quantize_pytree

    cfg = fr.FireRedConfig(d_model=64, enc_heads=4, enc_layers=1, dec_layers=1,
                           dec_heads=4, dec_ffn=96, vocab_size=100, conv_kernel=9)
    params = quantize_pytree(fr.init_params(cfg, jax.random.PRNGKey(0)),
                             bits=8, min_size=16)
    dw = params["enc_blocks"][0]["conv"]["dw"]["w"]
    assert isinstance(dw, jnp.ndarray) and not isinstance(dw, QuantizedLinear)
    # and a real matmul weight DID quantize
    assert isinstance(params["enc_blocks"][0]["conv"]["pw1"]["w"], QuantizedLinear)
    audio = jnp.asarray((np.random.default_rng(0).standard_normal((1, 8000)) * 2000)
                        .astype(np.float32))
    out = fr.transcribe(params, cfg, audio, jnp.asarray([8000], jnp.int32),
                        DecodeConfig(max_new_tokens=3, eot_id=-1))
    assert jax.tree.leaves(out)


@pytest.mark.parametrize("m,k,n", [(1, 1280, 1280), (3, 256, 384), (8, 512, 256),
                                   (1, 5120, 1280), (4, 1280, 3840)])
def test_quant_matvec_interpret_matches_f32_reference(m, k, n):
    """The decode-shape kernel (Pallas, interpret mode on the CPU) against
    the f32 dequant reference: it dequantizes in registers and accumulates
    in f32, so it is exact up to summation order."""
    from asr_jax.ops.quant_matmul import quant_matvec

    kw, kx = jax.random.split(jax.random.PRNGKey(m * 7 + k + n))
    w = jax.random.normal(kw, (k, n), jnp.float32) * 0.02
    x = jax.random.normal(kx, (m, k), jnp.float32)
    qleaf = quantize_linear(w, bits=8, block=128)
    want = np.asarray(jnp.dot(x, dequantize_weight(qleaf),
                              precision=jax.lax.Precision.HIGHEST))
    got = np.asarray(quant_matvec(x, qleaf["q"], qleaf["scale"], qleaf["zero"],
                                  interpret=True))
    assert got.shape == (m, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # each row is computed alone: one row through the kernel == that row of M
    one = np.asarray(quant_matvec(x[:1], qleaf["q"], qleaf["scale"], qleaf["zero"],
                                  interpret=True))
    np.testing.assert_array_equal(one[0], got[0])


def test_quant_matvec_split_planning():
    from asr_jax.ops.quant_matmul import _k_splits

    # enough programs (N tiles x K splits) to fill the card, K split in
    # power-of-two runs of 128-row quant blocks
    assert _k_splits(1280, 1280) == 10   # 10 tiles -> one block per split
    assert _k_splits(1280, 5120) == 10   # 40 tiles x 10
    assert _k_splits(5120, 1280) == 40
    assert _k_splits(1280, 52224) == 5   # 408 tiles: pairs of blocks suffice
    for k, n in ((1280, 1280), (5120, 1280), (1280, 52224), (4096, 4096)):
        s = _k_splits(k, n)
        per = (k // 128) // s
        assert (k // 128) % s == 0 and per & (per - 1) == 0


def test_quant_dense_routes_decode_shapes_to_matvec(monkeypatch):
    """Route choice: small-M unpacked int8 block-128 leaves in bf16 mode on
    a GPU take quant_matvec; everything else takes XLA."""
    from asr_jax.ops import quant_matmul as qm

    w = jnp.ones((256, 256), jnp.float32)
    q8 = quantize_linear(w, bits=8, block=128)
    q8_b64 = quantize_linear(w, bits=8, block=64)
    p4 = quantize_linear(w, bits=4, block=128, pack=True)
    x1, x9 = jnp.ones((1, 256)), jnp.ones((9, 256))
    assert not qm._matvec_applies(x1, q8)  # CPU backend
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert qm._matvec_applies(x1, q8)
    assert qm._matvec_applies(jnp.ones((8, 256)), q8)
    assert not qm._matvec_applies(x9, q8)
    assert not qm._matvec_applies(x1, q8_b64)
    assert not qm._matvec_applies(x1, p4)
    try:
        set_quant_config(mm="f32")
        assert not qm._matvec_applies(x1, q8)
    finally:
        set_quant_config(mm=None)
