"""Model artifact folders: weights (safetensors) + metadata.json + tokenizer.

Replaces the reference's optimized-folder layout (strategy graphs +
``*_SharedInitializers.onnx.data`` blob + ``ASR_Metadata.onnx`` + tokenizer
assets, reference ``Whisper/Shared_Merged.py:1653-1743``). One pytree per
model; "weight sharing across graphs" is inherent (there is one pytree) and
loading is an mmap'd safetensors read.

The safetensors format is read and written here with numpy alone: an 8-byte
little-endian header length, a JSON header mapping each name to its dtype,
shape and byte range, then the raw little-endian bytes. Files are
byte-identical to the ``safetensors`` package's ``save_file``.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any

import jax.numpy as jnp
import numpy as np

from asr_jax.runtime.metadata import ModelMetadata

WEIGHTS_FILENAME = "weights.safetensors"


def flatten_pytree(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    from asr_jax.quant.quantize import QuantizedEmbedding, QuantizedLinear

    out: dict[str, np.ndarray] = {}
    if isinstance(tree, QuantizedLinear):
        for k in ("q", "scale", "zero"):
            out[f"{prefix}__quant__/{k}"] = np.ascontiguousarray(np.asarray(tree[k]))
        out[f"{prefix}__quant__/bits"] = np.asarray(tree.bits, np.int32)
        out[f"{prefix}__quant__/block"] = np.asarray(tree.block, np.int32)
        out[f"{prefix}__quant__/packed"] = np.asarray(int(tree.packed), np.int32)
        out[f"{prefix}__quant__/dynamic"] = np.asarray(int(tree.dynamic), np.int32)
    elif isinstance(tree, QuantizedEmbedding):
        for k in ("q", "scale", "zero"):
            out[f"{prefix}__qembed__/{k}"] = np.ascontiguousarray(np.asarray(getattr(tree, k)))
        out[f"{prefix}__qembed__/bits"] = np.asarray(tree.bits, np.int32)
        out[f"{prefix}__qembed__/block"] = np.asarray(tree.block, np.int32)
        # tied-head orientation is derived (q.T) — store only the flag
        out[f"{prefix}__qembed__/tied"] = np.asarray(int(tree.q_t is not None), np.int32)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_pytree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_pytree(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.ascontiguousarray(np.asarray(tree))
    return out


def unflatten_pytree(flat: dict[str, np.ndarray]) -> Any:
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if "__quant__" in node and len(node) == 1:
            from asr_jax.quant.quantize import QuantizedLinear

            q = node["__quant__"]
            return QuantizedLinear(q["q"], q["scale"], q["zero"],
                                   int(q["bits"]), int(q["block"]),
                                   packed=bool(int(q.get("packed", 0))),
                                   dynamic=bool(int(q.get("dynamic", 0))))
        if "__qembed__" in node and len(node) == 1:
            from asr_jax.quant.quantize import QuantizedEmbedding

            q = node["__qembed__"]
            q_t = scale_t = zero_t = None
            q_t_packed = False
            if int(q.get("tied", 1)):
                from asr_jax.quant.quantize import tied_head_arrays
                import jax.numpy as _jnp

                q_t, scale_t, zero_t, q_t_packed = tied_head_arrays(
                    _jnp.asarray(np.ascontiguousarray(np.asarray(q["q"]).T)),
                    _jnp.asarray(np.ascontiguousarray(np.asarray(q["scale"]).T)),
                    _jnp.asarray(np.ascontiguousarray(np.asarray(q["zero"]).T)),
                    bits=int(q["bits"]), block=int(q["block"]),
                )
            return QuantizedEmbedding(q["q"], q["scale"], q["zero"],
                                      int(q["bits"]), int(q["block"]),
                                      q_t=q_t, scale_t=scale_t, zero_t=zero_t,
                                      q_t_packed=q_t_packed)
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def dedup_flat(flat: dict[str, np.ndarray]) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """Byte-identical tensor consolidation: each duplicate family keeps one
    canonical entry; the rest become alias rows (the reference dedups
    initializer byte-ranges into one shared blob and stores tied
    embed/LM-head weights once, ``Whisper/Shared_Merged.py:1653-1706,285``).

    Only tensors >= 1 KiB are considered (small biases aren't worth the
    metadata row). Returns (kept tensors, {alias_key: canonical_key})."""
    by_sig: dict[tuple, str] = {}
    kept: dict[str, np.ndarray] = {}
    aliases: dict[str, str] = {}
    for key, arr in flat.items():
        if arr.nbytes < 1024:
            kept[key] = arr
            continue
        sig = (arr.dtype.str, arr.shape, hash(arr.tobytes()))
        canon = by_sig.get(sig)
        # hash() collisions are broken by a full byte compare.
        if canon is not None and kept[canon].tobytes() == arr.tobytes():
            aliases[key] = canon
        else:
            by_sig[sig] = key
            kept[key] = arr
    return kept, aliases


# safetensors dtype codes, in the order the format's writer ranks them:
# tensors are laid out by descending rank, then by name.
_ST_DTYPES = {
    "BOOL": np.dtype(bool), "U8": np.dtype(np.uint8), "I8": np.dtype(np.int8),
    "I16": np.dtype(np.int16), "U16": np.dtype(np.uint16),
    "F16": np.dtype(np.float16), "BF16": np.dtype(jnp.bfloat16),
    "I32": np.dtype(np.int32), "U32": np.dtype(np.uint32),
    "F32": np.dtype(np.float32), "F64": np.dtype(np.float64),
    "I64": np.dtype(np.int64), "U64": np.dtype(np.uint64),
}
_ST_CODE = {dt: code for code, dt in _ST_DTYPES.items()}
_ST_RANK = {code: i for i, code in enumerate(_ST_DTYPES)}


def save_safetensors(tensors: dict[str, np.ndarray], path: str | Path) -> None:
    """Write ``{name: array}`` as a safetensors file."""
    arrays = {}
    for name, arr in tensors.items():
        arr = np.asarray(arr)
        code = _ST_CODE.get(arr.dtype.newbyteorder("="))
        if code is None:
            raise TypeError(f"{name}: dtype {arr.dtype} has no safetensors code")
        arrays[name] = (code, np.asarray(arr, arr.dtype.newbyteorder("<"), order="C"))
    order = sorted(arrays, key=lambda n: (-_ST_RANK[arrays[n][0]], n.encode()))
    header, offset = {}, 0
    for name in order:
        code, arr = arrays[name]
        header[name] = {"dtype": code, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
    head = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(head)))
        fh.write(head)
        for name in order:
            fh.write(arrays[name][1].tobytes())


def load_safetensors(path: str | Path) -> dict[str, np.ndarray]:
    """Read a safetensors file into read-only arrays over one mmap."""
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    (n,) = struct.unpack("<Q", raw[:8].tobytes())
    header = json.loads(raw[8:8 + n].tobytes())
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        start, end = info["data_offsets"]
        dtype = _ST_DTYPES[info["dtype"]].newbyteorder("<")
        out[name] = raw[8 + n + start:8 + n + end].view(dtype).reshape(info["shape"])
    return out


def save_model(folder: str | Path, params: Any, metadata: ModelMetadata) -> None:
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    flat, aliases = dedup_flat(flatten_pytree(params))
    if aliases:
        metadata.extra["weight_aliases"] = aliases
    else:
        metadata.extra.pop("weight_aliases", None)
    save_safetensors(flat, folder / WEIGHTS_FILENAME)
    metadata.save(folder)


def load_model(folder: str | Path, dtype=None) -> tuple[Any, ModelMetadata]:
    folder = Path(folder)
    flat = load_safetensors(folder / WEIGHTS_FILENAME)
    meta = ModelMetadata.load(folder)
    for alias, canon in meta.extra.get("weight_aliases", {}).items():
        flat[alias] = flat[canon]
    if dtype is not None:
        flat = {k: v.astype(dtype) for k, v in flat.items()}
    params = _to_device(unflatten_pytree(flat))
    return params, meta


def _to_device(tree: Any, _memo: dict | None = None) -> Any:
    """Host tree -> device tree. Aliased numpy leaves (weight dedup) map to
    ONE device buffer — N references, one physical HBM copy, matching the
    reference's mmap'd shared-initializer behavior."""
    from asr_jax.quant.quantize import QuantizedEmbedding, QuantizedLinear

    memo = _memo if _memo is not None else {}

    def put(x):
        key = id(x)
        if key not in memo:
            memo[key] = jnp.asarray(x)
        return memo[key]

    if isinstance(tree, QuantizedLinear):
        return QuantizedLinear(
            put(tree.q), put(tree.scale), put(tree.zero),
            tree.bits, tree.block, packed=tree.packed, dynamic=tree.dynamic,
        )
    if isinstance(tree, QuantizedEmbedding):
        return QuantizedEmbedding(
            put(tree.q), put(tree.scale), put(tree.zero), tree.bits, tree.block,
            q_t=None if tree.q_t is None else put(tree.q_t),
            scale_t=None if tree.scale_t is None else put(tree.scale_t),
            zero_t=None if tree.zero_t is None else put(tree.zero_t),
            q_t_packed=tree.q_t_packed,
        )
    if isinstance(tree, dict):
        return {k: _to_device(v, memo) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, memo) for v in tree]
    return put(tree)
