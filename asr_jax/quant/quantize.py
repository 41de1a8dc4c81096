"""Weight-only quantization (int8 / int4, block-wise) for serving.

The reference ships a 4,306-line ONNX quantization pipeline
(``Optimize_ONNX_Common.py``: Q2/Q4/Q8 weight-only via MatMulNBits with
DEFAULT/HQQ/RTN/k_quant/AFFINE_REFINE_V2 algorithms, a numba-JIT
refinement kernel :3120-3245, dynamic INT8, and an elaborate F16-overflow
guard system). The equivalents here are deliberately smaller:

- **bf16 serving** needs no machinery at all — bfloat16's exponent range
  removes the f16 overflow problem the reference fights (SURVEY.md §7.7);
  cast the pytree.
- **int8/int4 weight-only**: block-wise affine quantization of linear
  weights with (a) RTN (round-to-nearest) and (b) an iterative
  **affine refinement** that alternately re-fits scale/zero-point to
  minimize weight MSE — the reference's AFFINE_REFINE_V2 idea, expressed
  as a vectorized jitted JAX loop instead of a numba kernel.

Quantized leaves are ``QuantizedLinear`` pytree nodes;
``asr_jax.layers.transformer.dense`` consumes them transparently through
``asr_jax.ops.quant_matmul`` (block dequant + matmul, fused by XLA).
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np


def _fit_rtn(blocks: jnp.ndarray, qmax: int):
    """Symmetric-range affine fit per block. blocks (NB, B, N)."""
    wmin = jnp.min(blocks, axis=1, keepdims=True)
    wmax = jnp.max(blocks, axis=1, keepdims=True)
    scale = (wmax - wmin) / qmax
    scale = jnp.where(scale <= 1e-12, 1.0, scale)
    zero = jnp.round(-wmin / scale)
    return scale, zero


def _fit_kquant(blocks: jnp.ndarray, qmax: int, n_grid: int = 16):
    """k-quant-style fit: grid-search the block scale around the RTN range
    fit, scoring candidates by IMPORTANCE-WEIGHTED squared error with
    weights w_i = x_i^2 (large weights matter more after the matmul).

    The reference exposes a ``k_quant`` algorithm choice in its
    MatMulNBits pipeline (``Optimize_ONNX_Common.py`` quantization plans);
    this is the same idea expressed as a vectorized JAX sweep: for each
    candidate scale, the zero-point is re-fit as the weighted-optimal
    (rounded) offset, and the best (scale, zero) per block wins.
    """
    weights = blocks * blocks + 1e-12
    scale0, _ = _fit_rtn(blocks, qmax)
    wmin = jnp.min(blocks, axis=1, keepdims=True)
    factors = jnp.linspace(0.6, 1.2, n_grid)

    def score(factor):
        # Anchor the zero-point at the block minimum for each candidate
        # scale: shrunken scales clip outliers but sharpen the bulk, and the
        # weighted error decides which trade wins per block.
        scale = scale0 * factor
        zero = jnp.clip(jnp.round(-wmin / scale), 0, qmax)
        q = jnp.clip(jnp.round(blocks / scale + zero), 0, qmax)
        err = jnp.sum(weights * (blocks - (q - zero) * scale) ** 2, axis=1, keepdims=True)
        return err, scale, zero

    errs, scales, zeros = jax.vmap(score)(factors)  # (G, NB, 1, N)
    best = jnp.argmin(errs, axis=0, keepdims=True)  # (1, NB, 1, N)
    scale = jnp.take_along_axis(scales, best, axis=0)[0]
    zero = jnp.take_along_axis(zeros, best, axis=0)[0]
    return scale, zero


def _fit_hqq(blocks: jnp.ndarray, qmax: int, iters: int = 20,
             lp_norm: float = 0.7, beta0: float = 10.0, kappa: float = 1.01):
    """Half-Quadratic Quantization zero-point optimization (the reference's
    HQQ algorithm choice, ``Optimize_ONNX_Common.py:40-47`` matrix): with
    the range-fit scale fixed, minimize the ||W - deq(W)||_p^p (p<1)
    reconstruction error over the zero-point via half-quadratic splitting —
    alternating a generalized-soft-threshold shrink of the residual and a
    closed-form per-block zero update."""
    scale, zero = _fit_rtn(blocks, qmax)

    def shrink(x, beta):
        # Generalized soft-threshold for the |.|_p^{p<1} proximal operator.
        mag = jnp.abs(x)
        return jnp.sign(x) * jax.nn.relu(
            mag - (mag + 1e-8) ** (lp_norm - 1.0) / beta
        )

    def body(carry, _):
        zero, beta = carry
        q = jnp.clip(jnp.round(blocks / scale + zero), 0, qmax)
        err = blocks - (q - zero) * scale
        e = shrink(err, beta)
        zero = jnp.mean(q - (blocks - e) / scale, axis=1, keepdims=True)
        return (zero, beta * kappa), None

    (zero, _), _ = jax.lax.scan(body, (zero, beta0), None, length=iters)
    return scale, jnp.clip(jnp.round(zero), 0, qmax)


@functools.partial(jax.jit, static_argnames=("bits", "block", "refine_iters", "objective"))
def quantize_weight(
    w: jnp.ndarray, bits: int = 8, block: int = 128, refine_iters: int = 0,
    objective: str = "rtn",
):
    """Quantize a (K, N) weight block-wise along K.

    ``objective``: "rtn" (round-to-nearest range fit), "kquant"
    (importance-weighted grid search) or "hqq" (half-quadratic zero-point
    optimization). Returns (q uint8 (K, N), scale (NB, N), zero (NB, N))
    with ``w ≈ (q - zero) * scale`` per block.
    """
    k, n = w.shape
    assert k % block == 0, (k, block)
    qmax = (1 << bits) - 1
    blocks = w.reshape(k // block, block, n).astype(jnp.float32)
    if objective == "kquant":
        scale, zero = _fit_kquant(blocks, qmax)
    elif objective == "hqq":
        scale, zero = _fit_hqq(blocks, qmax)
    else:
        scale, zero = _fit_rtn(blocks, qmax)

    def quant(scale, zero):
        return jnp.clip(jnp.round(blocks / scale + zero), 0, qmax)

    def refine(carry, _):
        scale, zero = carry
        q = quant(scale, zero)
        # Re-fit scale by least squares on (q - zero) vs blocks, then re-fit zero.
        centered = q - zero
        num = jnp.sum(centered * blocks, axis=1, keepdims=True)
        den = jnp.sum(centered * centered, axis=1, keepdims=True)
        scale = jnp.where(den > 1e-12, num / jnp.maximum(den, 1e-12), scale)
        scale = jnp.where(jnp.abs(scale) <= 1e-12, 1.0, scale)
        q2 = quant(scale, zero)
        zero_f = jnp.mean(q2 - blocks / scale, axis=1, keepdims=True)
        zero = jnp.clip(jnp.round(zero_f), 0, qmax)
        return (scale, zero), None

    # HQQ's whole contribution is its Lp-optimized zero points: the MSE
    # refine loop would re-fit (scale, zero) by least squares and discard
    # them, silently degrading --algorithm hqq to rtn+refine.
    if refine_iters and objective != "hqq":
        (scale, zero), _ = jax.lax.scan(refine, (scale, zero), None, length=refine_iters)
    # Store centered int8 (q - 128, zero - 128): algebraically identical to
    # uint8 storage, and artifacts keep this layout.
    q = (quant(scale, zero) - 128.0).astype(jnp.int8).reshape(k, n)
    return q, scale[:, 0, :], zero[:, 0, :] - 128.0


@jax.tree_util.register_pytree_node_class
class QuantizedLinear:
    """Block-quantized linear weight; ``bits``/``block``/``packed`` are
    static pytree aux data so jitted functions see them as Python values.

    ``packed`` (4-bit only): rows ``[0, K/2)`` live in the LOW nibble and
    rows ``[K/2, K)`` in the HIGH nibble of a ``(K/2, N)`` int8 array —
    the halves stay K-contiguous so dequant decomposes into two partial
    matmuls with no interleaving."""

    def __init__(self, q, scale, zero, bits: int, block: int,
                 packed: bool = False, dynamic: bool = False):
        self.q = q
        self.scale = scale
        self.zero = zero
        self.bits = int(bits)
        self.block = int(block)
        self.packed = bool(packed)
        self.dynamic = bool(dynamic)  # dynamic-activation int8 matmul path

    def tree_flatten(self):
        return (self.q, self.scale, self.zero), (
            self.bits, self.block, self.packed, self.dynamic,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    # dict-style access kept for convenience / serialization.
    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key):
        return key in ("q", "scale", "zero", "bits", "block", "packed", "dynamic")

    @property
    def k(self) -> int:
        if not self.packed:
            return self.q.shape[0]
        return self.q.shape[0] * (4 if self.bits == 2 else 2)

    # Duck-type the dense (K, N) weight: models consult ``.dtype`` /
    # ``.shape`` on linear leaves (e.g. ``params["output"]["w"].dtype``).
    @property
    def dtype(self):
        return self.scale.dtype

    @property
    def shape(self) -> tuple[int, int]:
        return (self.k, self.q.shape[1])

    @property
    def ndim(self) -> int:
        return 2


def pack4_halves(q_unsigned: jnp.ndarray) -> jnp.ndarray:
    """(K, N) uint4-valued -> (K/2, N) int8: low nibble = rows [0, K/2),
    high nibble = rows [K/2, K)."""
    k = q_unsigned.shape[0]
    lo = q_unsigned[: k // 2].astype(jnp.uint8)
    hi = q_unsigned[k // 2 :].astype(jnp.uint8)
    return (lo | (hi << 4)).astype(jnp.int8)


def unpack4_halves(packed: jnp.ndarray) -> jnp.ndarray:
    """(K/2, N) int8 -> (K, N) float32 unsigned nibble values."""
    u = packed.astype(jnp.uint8)
    lo = (u & 0xF).astype(jnp.int32).astype(jnp.float32)
    hi = ((u >> 4) & 0xF).astype(jnp.int32).astype(jnp.float32)
    return jnp.concatenate([lo, hi], axis=0)


def pack2_quarters(q_unsigned: jnp.ndarray) -> jnp.ndarray:
    """(K, N) uint2-valued -> (K/4, N) int8: bit pair ``2j:2j+2`` holds rows
    ``[jK/4, (j+1)K/4)`` — quarters stay K-contiguous (same layout idea as
    :func:`pack4_halves`), so dequant is four contiguous partial matmuls."""
    k = q_unsigned.shape[0]
    quarters = [q_unsigned[j * (k // 4) : (j + 1) * (k // 4)].astype(jnp.uint8)
                for j in range(4)]
    out = quarters[0]
    for j in (1, 2, 3):
        out = out | (quarters[j] << (2 * j))
    return out.astype(jnp.int8)


def unpack2_quarters(packed: jnp.ndarray) -> jnp.ndarray:
    """(K/4, N) int8 -> (K, N) float32 unsigned 2-bit values."""
    u = packed.astype(jnp.uint8)
    parts = [((u >> (2 * j)) & 0x3).astype(jnp.int32).astype(jnp.float32)
             for j in range(4)]
    return jnp.concatenate(parts, axis=0)


def dequantize_weight(qleaf, dtype=jnp.float32) -> jnp.ndarray:
    """QuantizedLinear (or equivalent dict) -> dense (K, N) weight.

    Unpacked storage is CENTERED (q - 128, zero - 128); packed-4-bit
    storage keeps raw unsigned nibbles with an unsigned zero. Both give
    ``w = (q - zero) * scale`` per block."""
    packed = bool(qleaf["packed"]) if "packed" in qleaf else False
    if packed:
        q = unpack2_quarters(qleaf["q"]) if int(qleaf["bits"]) == 2 else unpack4_halves(qleaf["q"])
    else:
        q = qleaf["q"].astype(jnp.float32)
    k, n = q.shape
    block = int(qleaf["block"])
    blocks = q.reshape(k // block, block, n)
    w = (blocks - qleaf["zero"][:, None, :]) * qleaf["scale"][:, None, :]
    return w.reshape(k, n).astype(dtype)


def quantize_linear(
    w: jnp.ndarray, bits: int = 8, block: int = 128, refine_iters: int = 0,
    pack: bool = False, objective: str = "rtn",
):
    k = w.shape[0]
    if objective == "dynamic":
        # Dynamic-activation INT8 (reference ``quantize_dynamic_int8``,
        # ``Optimize_ONNX_Common.py:4049``): activations quantize per row at
        # call time, so the WEIGHT needs per-COLUMN scales (block = K) for
        # the whole product to stay one int8 x int8 -> int32 matmul.
        q, scale, zero = quantize_weight(w, 8, k, refine_iters, objective="rtn")
        return QuantizedLinear(q, scale, zero, 8, k, dynamic=True)
    if k % block != 0:
        # Fall back to one block per remainder-safe size.
        block = k
    q, scale, zero = quantize_weight(w, bits, block, refine_iters, objective=objective)
    if pack and bits == 4 and k % 2 == 0 and (k // 2) % block == 0:
        # Store raw unsigned nibbles; zero stays in unsigned convention.
        q_unsigned = (q.astype(jnp.int32) + 128).astype(jnp.uint8)
        return QuantizedLinear(pack4_halves(q_unsigned), scale, zero + 128.0, 4, block, packed=True)
    if pack and bits == 2 and k % 4 == 0 and (k // 4) % block == 0:
        q_unsigned = (q.astype(jnp.int32) + 128).astype(jnp.uint8)
        return QuantizedLinear(pack2_quarters(q_unsigned), scale, zero + 128.0, 2, block, packed=True)
    return QuantizedLinear(q, scale, zero, bits, block)


def dynamic_quant_dense(x: jnp.ndarray, qleaf: "QuantizedLinear") -> jnp.ndarray:
    """Dynamic-activation INT8 matmul: activations quantize per ROW
    (symmetric absmax) at call time, the product runs int8 x int8 -> int32,
    and the result rescales by (row scale x column scale). The
    DynamicQuantizeLinear + MatMulInteger analog (reference
    ``quantize_dynamic_int8``, ``Optimize_ONNX_Common.py:4049``)."""
    orig = x.shape
    x2 = x.reshape(-1, orig[-1]).astype(jnp.float32)
    absmax = jnp.max(jnp.abs(x2), axis=1, keepdims=True)
    sx = jnp.where(absmax > 0, absmax / 127.0, 1.0)
    xq = jnp.clip(jnp.round(x2 / sx), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(
        xq, qleaf.q, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32
    ).astype(jnp.float32)
    # (q - zero) expansion: subtract (sum_k xq) * zero_n — zero is per column.
    row_sum = jnp.sum(xq.astype(jnp.int32), axis=1, keepdims=True).astype(jnp.float32)
    y = (acc - row_sum * qleaf.zero) * sx * qleaf.scale
    return y.reshape(*orig[:-1], qleaf.q.shape[1]).astype(x.dtype)


@jax.tree_util.register_pytree_node_class
class QuantizedEmbedding:
    """Row-gatherable block-quantized embedding table — the reference's
    GatherBlockQuantized analog (``Optimize_ONNX_Common.py:3860`` area).

    Quantized along the EMBEDDING axis in ``block``-wide groups per row, so
    ``emb[ids]`` gathers + dequantizes only the touched rows. Tied LM heads
    go through :func:`embedding_logits`.
    """

    def __init__(self, q, scale, zero, bits: int, block: int,
                 q_t=None, scale_t=None, zero_t=None, q_t_packed: bool = False):
        self.q = q            # (V, D) int8, centered (q - 128)
        self.scale = scale    # (V, D // block)
        self.zero = zero      # (V, D // block), centered
        self.bits = int(bits)
        self.block = int(block)
        # Optional tied-LM-head copy in QuantizedLinear orientation
        # ((D, V_pad) int8, V zero-padded to a 512 multiple): logits route
        # through the quantized matmul over int8 bytes instead of a full
        # f32 table.  For 4-bit tables the copy is NIBBLE-PACKED
        # ((D/2, V_pad), ``q_t_packed=True``) — the head is the single
        # largest weight read of a decode step (D x V bytes unpacked) and
        # packing halves it; V then pads to a 2048 multiple.
        self.q_t = q_t
        self.scale_t = scale_t  # (NB, V_pad); unsigned-zero convention when packed
        self.zero_t = zero_t
        self.q_t_packed = bool(q_t_packed)

    def tree_flatten(self):
        return (self.q, self.scale, self.zero,
                self.q_t, self.scale_t, self.zero_t), (
                    self.bits, self.block, self.q_t_packed)

    @classmethod
    def tree_unflatten(cls, aux, children):
        q, scale, zero, q_t, scale_t, zero_t = children
        bits, block = aux[0], aux[1]
        packed = aux[2] if len(aux) > 2 else False
        return cls(q, scale, zero, bits, block,
                   q_t=q_t, scale_t=scale_t, zero_t=zero_t, q_t_packed=packed)

    def __getitem__(self, ids):
        ids = jnp.asarray(ids)
        rows = jnp.take(self.q, ids, axis=0).astype(jnp.float32)
        s = jnp.take(self.scale, ids, axis=0)
        z = jnp.take(self.zero, ids, axis=0)
        v, d = self.q.shape
        nb = self.scale.shape[1]
        rows = rows.reshape(*rows.shape[:-1], nb, d // nb)
        deq = (rows - z[..., None]) * s[..., None]
        return deq.reshape(*ids.shape, d)

    def dequant(self) -> jnp.ndarray:
        v, d = self.q.shape
        nb = self.scale.shape[1]
        rows = self.q.astype(jnp.float32).reshape(v, nb, d // nb)
        return ((rows - self.zero[..., None]) * self.scale[..., None]).reshape(v, d)

    @property
    def dtype(self):
        return self.scale.dtype

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self) -> int:
        return 2


def embedding_logits(embed, y: jnp.ndarray) -> jnp.ndarray:
    """Tied-head logits ``y @ embed.T`` for plain or quantized tables."""
    if isinstance(embed, QuantizedEmbedding):
        if embed.q_t is not None:
            # quantized matmul over the stored (D, V_pad) copy
            from asr_jax.ops.quant_matmul import quant_dense

            leaf = {"q": embed.q_t, "scale": embed.scale_t, "zero": embed.zero_t,
                    "bits": embed.bits, "block": embed.block,
                    "packed": embed.q_t_packed}
            return quant_dense(y, leaf)[..., : embed.q.shape[0]]
        # Blockwise decomposition: logits_v = sum_b s[v,b] (y_b . q[v,b])
        #                                   - sum_b s[v,b] z[v,b] sum(y_b)
        # — never materializes the f32 table (the naive dequant().T costs
        # a (V, D) f32 write+read PER DECODE STEP).
        v, d = embed.q.shape
        nb = embed.scale.shape[1]
        blk = d // nb
        y32 = y.astype(jnp.float32)
        yb = y32.reshape(*y.shape[:-1], nb, blk)
        qb = embed.q.reshape(v, nb, blk)
        part = jnp.einsum("...nk,vnk->...nv", yb, qb.astype(jnp.float32))
        ysum = yb.sum(-1)
        logits = jnp.einsum("...nv,vn->...v", part, embed.scale.astype(jnp.float32))
        logits -= jnp.einsum("...n,vn->...v", ysum,
                             (embed.scale * embed.zero).astype(jnp.float32))
        return logits.astype(y.dtype)
    return jnp.dot(y, embed.T)


def tied_head_arrays(q_t: jnp.ndarray, scale_t: jnp.ndarray, zero_t: jnp.ndarray,
                     bits: int = 8, block: int | None = None):
    """Prepare the (D, V) tied-head copy for the quantized matmul.

    Pads the V axis (zero scale in the pad keeps padded logits at exactly
    0; callers slice [:V]).  For 4-bit tables whose halves stay
    block-aligned the copy is additionally NIBBLE-PACKED to (D/2, V_pad)
    — the head is the largest weight read of every decode step and
    unpacked int8 storage doubles it — and V pads to a 2048 multiple (512
    otherwise).

    Returns (q_t, scale_t, zero_t, packed: bool)."""
    d, v = q_t.shape
    pack = (bits == 4 and block is not None and d % 2 == 0
            and (d // 2) % block == 0)
    pad = (-v) % (2048 if pack else 512)
    if pad:
        q_t = jnp.pad(q_t, ((0, 0), (0, pad)))
        scale_t = jnp.pad(scale_t, ((0, 0), (0, pad)))
        zero_t = jnp.pad(zero_t, ((0, 0), (0, pad)))
    if pack:
        # centered int8 -> raw unsigned nibbles; zero moves to the
        # unsigned convention (mirrors quantize_linear's packed storage).
        q_t = pack4_halves((q_t.astype(jnp.int32) + 128).astype(jnp.uint8))
        zero_t = zero_t + 128.0
    return q_t, scale_t, zero_t, pack


def quantize_embedding(
    w: jnp.ndarray, bits: int = 8, block: int = 128, objective: str = "rtn",
    tie_head: bool = True,
) -> QuantizedEmbedding:
    """(V, D) table -> per-row block quantization along D.

    ``tie_head``: also store the (D, V_pad) int8 orientation so a tied LM
    head runs through the quantized matmul (see :class:`QuantizedEmbedding`).
    """
    v, d = w.shape
    if d % block != 0:
        block = d
    # quantize_weight blocks along axis 0: feed the transpose.
    q, scale, zero = quantize_weight(w.T, bits, block, 0, objective=objective)
    q_t = scale_t = zero_t = None
    q_t_packed = False
    if tie_head:
        q_t, scale_t, zero_t, q_t_packed = tied_head_arrays(
            jnp.asarray(q), scale, zero, bits=bits, block=block)
    return QuantizedEmbedding(q.T, scale.T, zero.T, bits, block,
                              q_t=q_t, scale_t=scale_t, zero_t=zero_t,
                              q_t_packed=q_t_packed)


def is_quantized(leaf) -> bool:
    if isinstance(leaf, QuantizedLinear):
        return True
    return isinstance(leaf, dict) and "q" in leaf and "scale" in leaf and "bits" in leaf


def quantize_pytree(
    params,
    bits: int = 8,
    block: int = 128,
    refine_iters: int = 2,
    min_size: int = 1 << 16,
    predicate: Callable[[str, jnp.ndarray], bool] | None = None,
    pack: bool = False,
    objective: str = "rtn",
    quantize_embeddings: bool = False,
):
    """Quantize every 2-D ``{"w": ...}`` linear weight above ``min_size``
    elements (mirrors the reference's >=1024-element shared-initializer and
    node include/exclude plans, ``Optimize_ONNX_Common.py:85-135``).

    ``quantize_embeddings``: also quantize ``embed`` tables into
    gather-dequant :class:`QuantizedEmbedding` leaves (LLM-decoder
    families — Qwen3 lookups and tied logits route through them)."""

    # Depthwise/fusion-conv kernels are stored as 2-D {"w": (K, C)} dicts
    # but are consumed ELEMENTWISE (depthwise_conv1d_time indexes
    # weight[k]) or by conv_general_dilated, not through dense() —
    # quantizing them would hand the model a QuantizedLinear where it
    # expects a raw array. ("conv": Dolphin's csgu depthwise + the CIF
    # predictor conv; "fusion": Dolphin's E-Branchformer merge conv.)
    non_matmul_parents = ("dw", "dw1", "dw2", "conv", "fusion")

    def walk(node, path):
        parent = path.rsplit("/", 1)[-1]
        if isinstance(node, dict):
            out = {}
            for key, value in node.items():
                p = f"{path}/{key}"
                if (
                    key in ("w", "w1", "w2")
                    and parent not in non_matmul_parents
                    and isinstance(value, jnp.ndarray)
                    and value.ndim == 2
                    and value.size >= min_size
                    and (predicate is None or predicate(p, value))
                ):
                    out[key] = quantize_linear(value, bits, block, refine_iters,
                                               pack=pack, objective=objective)
                elif (
                    quantize_embeddings
                    and key == "embed"
                    and isinstance(value, jnp.ndarray)
                    and value.ndim == 2
                    and value.size >= min_size
                ):
                    out[key] = quantize_embedding(
                        value, max(bits, 8) if objective == "dynamic" else bits,
                        block, objective="rtn" if objective == "dynamic" else objective,
                    )
                else:
                    out[key] = walk(value, p)
            return out
        if isinstance(node, (list, tuple)):
            walked = [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
            return type(node)(walked) if isinstance(node, tuple) else walked
        return node

    return walk(params, "")


def quantization_error(w: jnp.ndarray, qleaf: dict) -> float:
    """Relative Frobenius error of the quantized representation."""
    deq = dequantize_weight(qleaf)
    return float(jnp.linalg.norm(w - deq) / jnp.maximum(jnp.linalg.norm(w), 1e-9))


def cast_pytree(params, dtype):
    """bf16/f32 serving cast (inexact leaves only)."""
    def cast(x):
        if isinstance(x, jnp.ndarray) and jnp.issubdtype(x.dtype, jnp.floating):
            return x.astype(dtype)
        return x

    return jax.tree.map(cast, params)
