"""Minimal ONNX initializer reader (no onnx or protobuf dependency).

Port of minimax_speech_tpu/utils/onnx_reader.py (numpy only): the
`onnx` package imports neither in the tests' environment nor on the
GPU machine, so this module parses the protobuf wire format just far
enough to pull `graph.initializer` tensors out of a .onnx file (the
campplus.onnx weights): ModelProto.graph = field 7,
GraphProto.initializer = repeated TensorProto field 5, TensorProto
{dims=1, data_type=2, float_data=4, int64_data=7, name=8, raw_data=9}.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, Tuple

import numpy as np

# ONNX TensorProto.DataType -> numpy
_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16,
           5: np.int16, 6: np.int32, 7: np.int64, 9: np.bool_,
           10: np.float16, 11: np.float64, 12: np.uint32, 13: np.uint64}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field_number, wire_type, payload) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:           # varint
            val, pos = _read_varint(buf, pos)
            yield field, wt, val
        elif wt == 1:         # 64-bit
            yield field, wt, buf[pos: pos + 8]
            pos += 8
        elif wt == 2:         # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, wt, buf[pos: pos + ln]
            pos += ln
        elif wt == 5:         # 32-bit
            yield field, wt, buf[pos: pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims, dtype, name = [], 1, ""
    raw = None
    floats, int64s = [], []
    for field, wt, val in _fields(buf):
        if field == 1:
            if wt == 0:
                dims.append(val)
            else:  # packed
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    dims.append(v)
        elif field == 2:
            dtype = val
        elif field == 4:
            if wt == 2:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif field == 7:
            if wt == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    int64s.append(v)
            else:
                int64s.append(val)
        elif field == 8:
            name = val.decode("utf-8")
        elif field == 9:
            raw = val
    np_dtype = _DTYPES.get(dtype, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, np_dtype)
    elif floats:
        arr = np.asarray(floats, np.float32)
    elif int64s:
        arr = np.asarray(int64s, np.int64)
    else:
        arr = np.zeros(0, np_dtype)
    return name, arr.reshape(dims) if dims else arr


def read_onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    """{initializer name: array} from a .onnx file."""
    with open(path, "rb") as f:
        buf = f.read()
    out: Dict[str, np.ndarray] = {}
    for field, wt, val in _fields(buf):
        if field == 7 and wt == 2:               # ModelProto.graph
            for gf, gwt, gval in _fields(val):
                if gf == 5 and gwt == 2:         # GraphProto.initializer
                    name, arr = _parse_tensor(gval)
                    out[name] = arr
    return out
