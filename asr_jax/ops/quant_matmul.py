"""Dense layers through weight-only-quantized linears.

The reference lowers Q4/Q8 weights to ONNX Runtime's ``MatMulNBits``
contrib op (``Optimize_ONNX_Common.py:27``). Here the block dequant
``(q - zero) * scale`` and the matmul are plain XLA, except at decode
shapes on the GPU: there XLA writes a weight-sized intermediate to device
memory (at M=1 the dot becomes a multiply fusion producing f32 (K, N) and
a reduce; at larger M a bf16 dequantized copy feeds cuBLAS), so a few rows
times an unpacked int8 weight go through :func:`quant_matvec`, a Pallas
kernel for the Triton backend that reads only the int8 bytes.

Matmul mode once the weight is dequantized:
  "bf16" (default): bf16 weight and activation operands, one
    tensor-core pass, f32 accumulation. Rounding is ~2^-8 relative — for
    q4/q2 far below the quantization error; for q8 *comparable* to it (the
    q8 block-quant error is also ~2^-8 of the block range), an accepted
    serving trade.
  "f32": dequantize to f32 and run Precision.HIGHEST — exact against the
    f32 dequant reference; used by parity/validation paths.

Configuration precedence (env sniffing alone is fragile for in-process
callers that trace before setting the env var):
  1. ``set_quant_config(mm=...)`` — the session/CLI plumbing calls this
     BEFORE building jitted functions,
  2. the ASR_JAX_QUANT_MM env var, read at TRACE time,
  3. default "bf16".
None of these retrace already-compiled functions — configure before the
first jit of a session.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

_MM_ENV = "ASR_JAX_QUANT_MM"

_CONFIG: dict = {"mm": None}


def set_quant_config(mm: str | None = None) -> None:
    """Process-wide quantized-matmul mode (overrides the env var); None
    clears the override.

    Call before the first jitted forward of a session; changing it later
    does not retrace already-compiled functions."""
    if mm is not None:
        _mm_cfg(mm)
    _CONFIG["mm"] = mm


def _resolve_mm() -> str:
    if _CONFIG["mm"] is not None:
        return _CONFIG["mm"]
    return os.environ.get(_MM_ENV, "bf16")


def _mm_cfg(mm: str):
    if mm == "f32":
        return jnp.float32, jax.lax.Precision.HIGHEST
    if mm != "bf16":
        # A typo'd mode (F32, fp32, "f32 ") silently selecting the
        # approximate path would corrupt parity runs — fail loudly.
        raise ValueError(f"{_MM_ENV} / mm must be 'bf16' or 'f32', got {mm!r}")
    return jnp.bfloat16, jax.lax.Precision.DEFAULT


def _xla_quant_dense(x: jnp.ndarray, qleaf: dict) -> jnp.ndarray:
    """(..., K) @ dequant(qleaf) -> (..., N) in the configured mode."""
    from asr_jax.quant.quantize import dequantize_weight

    dtype, precision = _mm_cfg(_resolve_mm())
    w = dequantize_weight(qleaf, dtype=dtype)
    return jnp.dot(
        x.astype(dtype), w, precision=precision,
        preferred_element_type=jnp.float32,
    ).astype(x.dtype)


# quant_matvec geometry: rows of x up to MATVEC_MAX_M; each program owns
# one _BLOCK_N column tile of one K split and steps through it one quant
# block (_BLOCK_K rows, one scale/zero row) at a time.
MATVEC_MAX_M = 8
_BLOCK_N = 128
_BLOCK_K = 128
_TARGET_PROGRAMS = 264  # two per SM of an H100


def _matvec_kernel(x_ref, q_ref, s_ref, z_ref, o_ref, *, m: int, k_steps: int):
    """x (m, K_split) f32, q (K_split, BN) int8, scale/zero (k_steps, BN)
    -> o (m, BN) f32 partial sums of this K split."""

    def body(i, accs):
        rows = pl.ds(i * _BLOCK_K, _BLOCK_K)
        w = ((q_ref[rows, :].astype(jnp.float32) - z_ref[pl.ds(i, 1), :])
             * s_ref[pl.ds(i, 1), :])
        return tuple(acc + jnp.sum(w * x_ref[r, rows][:, None], axis=0)
                     for r, acc in enumerate(accs))

    zero = jnp.zeros((_BLOCK_N,), jnp.float32)
    accs = jax.lax.fori_loop(0, k_steps, body, (zero,) * m)
    for r, acc in enumerate(accs):
        o_ref[r, :] = acc


def _k_splits(k: int, n: int) -> int:
    """Number of K splits: the fewest (largest power-of-two run of quant
    blocks per split) that still gives enough programs to fill the card."""
    nkb = k // _BLOCK_K
    per = nkb & -nkb  # largest power of two dividing nkb
    while per > 1 and (n // _BLOCK_N) * (nkb // per) < _TARGET_PROGRAMS:
        per //= 2
    return nkb // per


@functools.partial(jax.jit, static_argnames=("interpret",))
def quant_matvec(x: jnp.ndarray, q: jnp.ndarray, scale: jnp.ndarray,
                 zero: jnp.ndarray, interpret: bool = False) -> jnp.ndarray:
    """x (M, K) @ dequant(q (K, N) int8, block 128) -> (M, N) f32 for small
    M. Dequantizes in registers and accumulates in f32; the K splits are
    summed by XLA (a (splits, M, N) f32 partial)."""
    m, k = x.shape
    n = q.shape[1]
    splits = _k_splits(k, n)
    k_split = k // splits
    k_steps = k_split // _BLOCK_K
    partial = pl.pallas_call(
        functools.partial(_matvec_kernel, m=m, k_steps=k_steps),
        out_shape=jax.ShapeDtypeStruct((splits, m, n), jnp.float32),
        grid=(n // _BLOCK_N, splits),
        in_specs=[
            pl.BlockSpec((m, k_split), lambda j, s: (0, s)),
            pl.BlockSpec((k_split, _BLOCK_N), lambda j, s: (s, j)),
            pl.BlockSpec((k_steps, _BLOCK_N), lambda j, s: (s, j)),
            pl.BlockSpec((k_steps, _BLOCK_N), lambda j, s: (s, j)),
        ],
        out_specs=pl.BlockSpec((None, m, _BLOCK_N), lambda j, s: (s, 0, j)),
        compiler_params=pl_triton.CompilerParams(num_warps=4, num_stages=3),
        backend="triton",
        interpret=interpret,
        name="quant_matvec",
    )(x.astype(jnp.float32), q, scale.astype(jnp.float32), zero.astype(jnp.float32))
    return partial.sum(axis=0)


def _matvec_applies(x2: jnp.ndarray, qleaf: dict) -> bool:
    """Decode-shape int8 leaves in bf16 mode on the GPU."""
    packed = bool(qleaf["packed"]) if "packed" in qleaf else False
    k, n = qleaf["q"].shape
    return (x2.shape[0] <= MATVEC_MAX_M and not packed
            and qleaf["q"].dtype == jnp.int8 and int(qleaf["block"]) == _BLOCK_K
            and k % _BLOCK_K == 0 and n % _BLOCK_N == 0
            and _resolve_mm() == "bf16" and jax.default_backend() == "gpu")


def quant_dense(x: jnp.ndarray, qleaf: dict) -> jnp.ndarray:
    """Batched dense through a quantized weight (any leading dims)."""
    k = x.shape[-1]
    n = qleaf["q"].shape[1]
    x2 = x.reshape(-1, k)
    if _matvec_applies(x2, qleaf):
        out = quant_matvec(x2, qleaf["q"], qleaf["scale"], qleaf["zero"]).astype(x.dtype)
    else:
        out = _xla_quant_dense(x2, qleaf)
    return out.reshape(x.shape[:-1] + (n,))
