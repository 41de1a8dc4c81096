"""Device meshes and sharding for multi-chip serving/training.

The reference is single-process/single-device (SURVEY.md §2: no
parallelism exists to mirror); the scaling story here is
``jax.sharding`` over a device mesh:

- **data**: batch data-parallel — the throughput axis for serving
  (independent audio windows per chip, collective-free inference).
- **model**: tensor-parallel sharding of the wide matmuls (qkv/out/ffn/
  vocab head) for models whose per-chip HBM or latency demands it; XLA
  inserts the psum/all-gathers from sharding constraints.
"""

from __future__ import annotations

from typing import Any

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: int | None = None, model_parallel: int = 1, devices=None
) -> Mesh:
    """Create a (data, model) mesh over the first ``n_devices`` devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    assert n_devices % model_parallel == 0, (n_devices, model_parallel)
    grid = np.array(devices[:n_devices]).reshape(
        n_devices // model_parallel, model_parallel
    )
    return Mesh(grid, ("data", "model"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharded(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("data"))


def _sanm_block_spec(in_size_key: str = "qkv") -> dict:
    """Tensor-parallel PartitionSpecs for one SANM block: qkv/ffn-in are
    column-sharded, out/ffn-out row-sharded (Megatron layout); XLA adds the
    psum at the row-sharded matmuls."""
    return {
        "norm1": {"scale": P(), "bias": P()},
        "qkv": {"w": P(None, "model"), "b": P("model")},
        "fsmn_w": P(None, "model"),
        "out": {"w": P("model", None), "b": P()},
        "norm2": {"scale": P(), "bias": P()},
        "ffn": {"w1": P(None, "model"), "b1": P("model"), "w2": P("model", None), "b2": P()},
    }


def sensevoice_param_specs(params: Any) -> Any:
    """PartitionSpec pytree matching a SenseVoice param pytree."""
    return {
        "cmvn_means": P(),
        "cmvn_istd": P(),
        "language_embed": P(),
        "system_embed": P(),
        "encoders0": [_sanm_block_spec() for _ in params["encoders0"]],
        "encoders": [_sanm_block_spec() for _ in params["encoders"]],
        "tp_encoders": [_sanm_block_spec() for _ in params["tp_encoders"]],
        "after_norm": {"scale": P(), "bias": P()},
        "tp_norm": {"scale": P(), "bias": P()},
        "ctc": {"w": P(None, "model"), "b": P("model")},
    }


def _specs_by_rule(params: Any, rule) -> Any:
    """Build a PartitionSpec pytree mirroring ``params`` exactly: ``rule``
    maps a '/'-joined key path to a spec; unmatched leaves replicate. This
    tolerates optional leaves (bias-less linears, tied heads).

    Quantized weights (``QuantizedLinear``) are treated as single leaves at
    their '.../w' path so the rules match them: a COLUMN-sharded position
    shards q/scale/zero on their shared output axis (exact — block
    quantization is per column); a ROW-sharded position replicates (the
    packed int4/int2 row layout interleaves nibble planes across the K
    axis, which a row split would tear apart)."""
    from asr_jax.quant.quantize import QuantizedLinear

    def assign(path, leaf):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        spec = rule(key)
        if isinstance(leaf, QuantizedLinear):
            if spec == P(None, "model"):
                col = P(None, "model")
                return QuantizedLinear(col, col, col, leaf.bits, leaf.block,
                                       leaf.packed, leaf.dynamic)
            rep = P()
            return QuantizedLinear(rep, rep, rep, leaf.bits, leaf.block,
                                   leaf.packed, leaf.dynamic)
        return spec

    return jax.tree_util.tree_map_with_path(
        assign, params, is_leaf=lambda x: isinstance(x, QuantizedLinear))


def whisper_param_specs(params: Any) -> Any:
    """Tensor-parallel PartitionSpecs for a Whisper pytree (the large-v3
    encoder/decoder are where per-chip HBM or latency can demand TP).
    Megatron layout: attention q/k/v and mlp fc1 column-sharded over the
    ``model`` axis (heads must divide it), o/fc2 row-sharded — XLA inserts
    the psum at the row matmuls. Embeddings/convs/norms replicate."""

    def rule(key: str):
        for proj in ("attn/q", "attn/k", "attn/v", "cross/q", "cross/k",
                     "cross/v", "mlp/fc1"):
            if key.endswith(proj + "/w"):
                return P(None, "model")
            if key.endswith(proj + "/b"):
                return P("model")
        for proj in ("attn/o", "cross/o", "mlp/fc2"):
            if key.endswith(proj + "/w"):
                return P("model", None)
        return P()

    return _specs_by_rule(params, rule)


def qwen3_param_specs(params: Any) -> Any:
    """Tensor-parallel PartitionSpecs for a Qwen3 decoder pytree (0.6B LLM
    decoders of Qwen3-ASR / Fun-ASR-Nano). GQA: kv heads must divide the
    model-axis size; per-head q/k RMSNorm scales replicate (they span
    head_dim, not heads)."""

    def rule(key: str):
        # qkv/gateup are the fuse_params() fused leaves — column-sharding
        # the concatenated output dim is still exact under GSPMD.
        for proj in ("attn/q", "attn/k", "attn/v", "attn/qkv",
                     "mlp/gate", "mlp/up", "mlp/gateup", "lm_head"):
            if key.endswith(proj + "/w"):
                return P(None, "model")
            if key.endswith(proj + "/b"):
                return P("model")
        for proj in ("attn/o", "mlp/down"):
            if key.endswith(proj + "/w"):
                return P("model", None)
        return P()

    return _specs_by_rule(params, rule)


def _fit_spec(spec: P, shape: tuple[int, ...], mesh: Mesh) -> P:
    """Replicate each dimension the mesh axes of ``spec`` do not divide
    (e.g. SenseVoice's 25055-token CTC head over 2 devices)."""
    fitted = []
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        names = () if axes is None else axes if isinstance(axes, tuple) else (axes,)
        size = int(np.prod([mesh.shape[a] for a in names]))
        fitted.append(axes if dim % size == 0 else None)
    return P(*fitted)


def shard_params(params: Any, mesh: Mesh, specs: Any | None = None) -> Any:
    """Place a param pytree on the mesh (replicated by default, or per-spec)."""
    if specs is None:
        sharding = replicated(mesh)
        return jax.device_put(params, sharding)
    shardings = jax.tree.map(
        lambda spec, x: NamedSharding(mesh, _fit_spec(spec, x.shape, mesh)),
        specs,
        params,
        is_leaf=lambda x: isinstance(x, P),
    )
    return jax.device_put(params, shardings)
