"""Minimal pure-Python codec for BSON.jl files (Julia's BSON flavor).

The port's own copy of ``regneuralde_tpu/data/bson.py`` (numpy only; the
port imports nothing of the JAX package). The reference stores its
real-data bundles as BSON.jl blobs consumed with ``BSON.load``: the
Physionet bundle (src/dataset.jl:65) and the toy-SDE ground truth
(experiments/sde_toy_problem.jl:8-10). This module decodes that format
without Julia: standard BSON documents in which BSON.jl represents Julia
values as tagged sub-documents:

* ``{"tag": "array", "type": <datatype>, "size": [d0, d1, ...],
  "data": <binary>}`` — a dense array, column-major (Julia memory order).
* ``{"tag": "datatype", "name": ["Core", "Float32"], "params": [...]}`` —
  a type reference; only bits types are needed here.
* ``{"tag": "symbol", "name": s}`` — a Julia Symbol (decoded to ``str``).
* ``{"tag": "backref", "ref": i}`` — 1-based index into the document's
  top-level ``_backrefs`` list (BSON.jl dedups repeated large objects).
* ``Dict{Symbol,T}`` / ``Dict{String,T}`` map directly to BSON documents,
  so nested dicts need no tag handling.

A matching writer is provided so tests can fabricate BSON.jl-compatible
fixtures (e.g. a physionet-schema bundle) without Julia.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Dict, List, Tuple, Union

import numpy as np

_JULIA_DTYPES = {
    "Float64": np.dtype("<f8"),
    "Float32": np.dtype("<f4"),
    "Float16": np.dtype("<f2"),
    "Int64": np.dtype("<i8"),
    "Int32": np.dtype("<i4"),
    "Int16": np.dtype("<i2"),
    "Int8": np.dtype("i1"),
    "UInt64": np.dtype("<u8"),
    "UInt32": np.dtype("<u4"),
    "UInt16": np.dtype("<u2"),
    "UInt8": np.dtype("u1"),
    "Bool": np.dtype("b1"),
}


# ---------------------------------------------------------------------------
# Raw BSON layer
# ---------------------------------------------------------------------------


def _parse_cstring(buf: bytes, i: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", i)
    return buf[i:end].decode("utf-8"), end + 1


def _parse_doc(buf: bytes, i: int) -> Tuple[Dict[str, Any], int]:
    (length,) = struct.unpack_from("<i", buf, i)
    end = i + length
    i += 4
    out: Dict[str, Any] = {}
    while buf[i] != 0:
        etype = buf[i]
        name, i = _parse_cstring(buf, i + 1)
        if etype == 0x01:  # double
            (val,) = struct.unpack_from("<d", buf, i)
            i += 8
        elif etype == 0x02:  # string
            (slen,) = struct.unpack_from("<i", buf, i)
            val = buf[i + 4 : i + 3 + slen].decode("utf-8")
            i += 4 + slen
        elif etype in (0x03, 0x04):  # embedded document / array
            val, i = _parse_doc(buf, i)
            if etype == 0x04:
                val = [val[str(k)] for k in range(len(val))]
        elif etype == 0x05:  # binary
            (blen,) = struct.unpack_from("<i", buf, i)
            val = bytes(buf[i + 5 : i + 5 + blen])  # skip subtype byte
            i += 5 + blen
        elif etype == 0x08:  # bool
            val = buf[i] != 0
            i += 1
        elif etype == 0x0A:  # null
            val = None
        elif etype == 0x10:  # int32
            (val,) = struct.unpack_from("<i", buf, i)
            i += 4
        elif etype == 0x12:  # int64
            (val,) = struct.unpack_from("<q", buf, i)
            i += 8
        else:
            raise ValueError(f"unsupported BSON element type 0x{etype:02x}")
        out[name] = val
    if i + 1 != end:
        raise ValueError("BSON document length mismatch")
    return out, end


# ---------------------------------------------------------------------------
# BSON.jl tagged-value layer
# ---------------------------------------------------------------------------


def _dtype_name(type_doc: Any) -> str:
    """Extract the leaf type name from a BSON.jl datatype doc (or backref-
    resolved equivalent): ``{"tag": "datatype", "name": ["Core","Float32"]}``."""
    if isinstance(type_doc, dict):
        name = type_doc.get("name")
        if isinstance(name, list) and name:
            return str(name[-1])
    raise ValueError(f"cannot interpret BSON.jl datatype: {type_doc!r}")


def _from_julia(val: Any, backrefs: List[Any]) -> Any:
    if isinstance(val, dict):
        tag = val.get("tag")
        if tag == "backref":
            return _from_julia(backrefs[int(val["ref"]) - 1], backrefs)
        if tag == "symbol":
            return str(val["name"])
        if tag == "datatype":
            return _dtype_name(val)
        if tag == "tuple":
            return tuple(_from_julia(v, backrefs) for v in val["data"])
        if tag == "array":
            eltype = _from_julia(val["type"], backrefs)
            size = [int(s) for s in val["size"]]
            data = val["data"]
            if isinstance(data, (bytes, bytearray)):
                dt = _JULIA_DTYPES.get(str(eltype))
                if dt is None:
                    raise ValueError(f"unsupported array eltype {eltype!r}")
                arr = np.frombuffer(bytes(data), dtype=dt)
                return arr.reshape(size, order="F")  # Julia is column-major
            # Non-bits eltype: data is a BSON list of tagged values.
            items = [_from_julia(v, backrefs) for v in data]
            out = np.empty(len(items), dtype=object)
            out[:] = items
            return out.reshape(size, order="F")
        # Plain nested Dict{Symbol/String} — a BSON document.
        return {k: _from_julia(v, backrefs) for k, v in val.items()}
    if isinstance(val, list):
        return [_from_julia(v, backrefs) for v in val]
    return val


def loads(data: bytes) -> Dict[str, Any]:
    """Decode one BSON.jl blob into a dict of Python/NumPy values."""
    doc, _ = _parse_doc(data, 0)
    backrefs = doc.pop("_backrefs", []) or []
    return {k: _from_julia(v, backrefs) for k, v in doc.items()}


def load_bson(path: Union[str, Path]) -> Dict[str, Any]:
    """Read a BSON.jl file (e.g. the reference's data/sde_demo.bson)."""
    return loads(Path(path).read_bytes())


# ---------------------------------------------------------------------------
# Writer (fixtures/tests): emits the same representation BSON.jl produces
# ---------------------------------------------------------------------------


def _enc_cstring(s: str) -> bytes:
    return s.encode("utf-8") + b"\x00"


def _enc_element(name: str, val: Any) -> bytes:
    key = _enc_cstring(name)
    if isinstance(val, bool):
        return b"\x08" + key + (b"\x01" if val else b"\x00")
    if isinstance(val, (int, np.integer)):
        return b"\x12" + key + struct.pack("<q", int(val))
    if isinstance(val, (float, np.floating)):
        return b"\x01" + key + struct.pack("<d", float(val))
    if isinstance(val, str):
        raw = val.encode("utf-8") + b"\x00"
        return b"\x02" + key + struct.pack("<i", len(raw)) + raw
    if isinstance(val, (bytes, bytearray)):
        return b"\x05" + key + struct.pack("<i", len(val)) + b"\x00" + bytes(val)
    if isinstance(val, np.ndarray):
        return _enc_element(name, _lower_array(val))
    if isinstance(val, (list, tuple)):
        body = b"".join(_enc_element(str(j), v) for j, v in enumerate(val))
        doc = struct.pack("<i", len(body) + 5) + body + b"\x00"
        return b"\x04" + key + doc
    if isinstance(val, dict):
        return b"\x03" + key + _enc_doc(val)
    if val is None:
        return b"\x0A" + key
    raise TypeError(f"cannot encode {type(val)} into BSON")


def _enc_doc(doc: Dict[str, Any]) -> bytes:
    body = b"".join(_enc_element(k, v) for k, v in doc.items())
    return struct.pack("<i", len(body) + 5) + body + b"\x00"


def _lower_array(arr: np.ndarray) -> Dict[str, Any]:
    jl_name = {v: k for k, v in _JULIA_DTYPES.items()}.get(
        np.dtype(arr.dtype).newbyteorder("<")
    )
    if jl_name is None:
        raise TypeError(f"no Julia bits type for dtype {arr.dtype}")
    return {
        "tag": "array",
        "type": {"tag": "datatype", "params": [], "name": ["Core", jl_name]},
        "size": [int(s) for s in arr.shape],
        "data": np.asfortranarray(arr).astype(
            np.dtype(arr.dtype).newbyteorder("<"), copy=False
        ).tobytes(order="F"),
    }


def dumps(doc: Dict[str, Any]) -> bytes:
    """Encode a dict (values: scalars, strings, numpy arrays, nested dicts,
    lists) as a BSON.jl-compatible blob."""
    return _enc_doc(doc)


def dump_bson(path: Union[str, Path], doc: Dict[str, Any]) -> None:
    Path(path).write_bytes(dumps(doc))
