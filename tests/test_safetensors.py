"""The numpy safetensors reader/writer behind model artifacts: round trips
for every dtype the format names, byte equality with the ``safetensors``
package where it is installed, and artifacts the package wrote still
load."""

import json
import struct

import jax.numpy as jnp
import numpy as np
import pytest

from asr_jax.runtime.artifact import load_safetensors, save_safetensors

DTYPES = ["bool", "uint8", "int8", "int16", "uint16", "float16", "bfloat16",
          "int32", "uint32", "float32", "float64", "int64", "uint64"]


def _array(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    dt = np.dtype(jnp.bfloat16) if dtype == "bfloat16" else np.dtype(dtype)
    return (rng.standard_normal(shape) * 50).astype(dt)


def _tensors():
    out = {f"layer/{i}/{dt}": _array(dt, (3, 5), i) for i, dt in enumerate(DTYPES)}
    out["scalar"] = np.asarray(7, np.int32)
    out["empty"] = np.zeros((0, 4), np.float32)
    out["b/same-dtype"] = _array("float32", (2,), 99)
    out["a/same-dtype"] = _array("float32", (4, 1), 98)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_round_trip_each_dtype(tmp_path, dtype):
    arr = _array(dtype, (4, 3, 2), 0)
    save_safetensors({"x": arr, "s": arr[0, 0, 0]}, tmp_path / "t.safetensors")
    back = load_safetensors(tmp_path / "t.safetensors")
    assert back["x"].dtype == arr.dtype and back["x"].shape == arr.shape
    np.testing.assert_array_equal(back["x"], arr)
    assert back["s"].shape == () and back["s"] == arr[0, 0, 0]


def test_round_trip_mixed_file_and_layout(tmp_path):
    """Header: 8-byte little-endian length, compact JSON padded to a
    multiple of 8; data sorted by descending dtype rank, then by name."""
    tensors = _tensors()
    path = tmp_path / "m.safetensors"
    save_safetensors(tensors, path)
    raw = path.read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    assert n % 8 == 0
    header = json.loads(raw[8:8 + n])
    order = sorted(header, key=lambda k: header[k]["data_offsets"][0])
    assert order[0] == "layer/12/uint64" and order[-1] == "layer/0/bool"
    assert order.index("a/same-dtype") < order.index("b/same-dtype")
    assert len(raw) == 8 + n + max(v["data_offsets"][1] for v in header.values())
    back = load_safetensors(path)
    assert set(back) == set(tensors)
    for k, v in tensors.items():
        np.testing.assert_array_equal(back[k], v)


def test_bytes_equal_safetensors_package(tmp_path):
    st = pytest.importorskip("safetensors.numpy")
    tensors = {k: v for k, v in _tensors().items()
               if v.dtype != np.dtype(jnp.bfloat16)}
    ours, theirs = tmp_path / "ours.safetensors", tmp_path / "theirs.safetensors"
    save_safetensors(tensors, ours)
    st.save_file(tensors, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()


def test_loads_artifact_written_by_package(tmp_path):
    """Artifacts saved before the numpy writer existed still load."""
    st = pytest.importorskip("safetensors.numpy")
    from asr_jax.runtime.artifact import WEIGHTS_FILENAME, load_model
    from asr_jax.runtime.metadata import ModelMetadata

    w = _array("float32", (8, 4), 1)
    folder = tmp_path / "m"
    folder.mkdir()
    st.save_file({"layer/w": w, "layer/b": w[0]}, str(folder / WEIGHTS_FILENAME))
    ModelMetadata(family="x").save(folder)
    params, meta = load_model(folder)
    assert meta.family == "x"
    np.testing.assert_array_equal(np.asarray(params["layer"]["w"]), w)
    np.testing.assert_array_equal(np.asarray(params["layer"]["b"]), w[0])


def test_unknown_dtype_rejected(tmp_path):
    with pytest.raises(TypeError):
        save_safetensors({"c": np.zeros(2, np.complex64)}, tmp_path / "c.safetensors")
