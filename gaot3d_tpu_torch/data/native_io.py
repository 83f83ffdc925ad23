"""ctypes bindings for the native gaot_io runtime (native/gaot_io.cpp; port of
gaot3d_tpu/data/native_io.py over the same source).

Provides the .gsb flat-binary sample format: written from Python, read through
mmap by the C++ library with zero copies (numpy views straight into the file
mapping), plus threaded padded-batch assembly. The library is compiled with
g++ at first use into `.build/gaot3d_tpu_torch/`; a failed build raises, as in
`host_graph.py`: there is no numpy fallback on the data feed's path.
`read_gsb_numpy` stays as the format's plain reader, to hold the native one
against.
"""
from __future__ import annotations

import ctypes
import os
import struct
from typing import Dict

import numpy as np

from ..kernels.build import REPO_ROOT, load_library

_DTYPES = {0: np.float32, 1: np.int32, 2: np.uint8, 3: np.float64, 4: np.int64, 5: np.bool_}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_SRC = os.path.join(REPO_ROOT, "native", "gaot_io.cpp")


def _io_library() -> ctypes.CDLL:
    lib = load_library(
        "gaot_io", [_SRC],
        lambda out: ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", out, _SRC,
                     "-lpthread"])
    lib.gsb_open.restype = ctypes.c_void_p
    lib.gsb_open.argtypes = [ctypes.c_char_p]
    lib.gsb_num_arrays.argtypes = [ctypes.c_void_p]
    lib.gsb_name.restype = ctypes.c_char_p
    lib.gsb_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gsb_dtype.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gsb_ndim.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gsb_dims.restype = ctypes.POINTER(ctypes.c_int64)
    lib.gsb_dims.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gsb_data.restype = ctypes.c_void_p
    lib.gsb_data.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gsb_close.argtypes = [ctypes.c_void_p]
    lib.pad_batch_f32.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    return lib


def write_gsb(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Write the flat binary sample format (atomic tmp+replace)."""
    items = []
    header = bytearray(b"GSB1")
    header += struct.pack("<I", len(arrays))
    # first pass to size the header
    metas = []
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        code = _CODES[np.dtype(arr.dtype)]
        metas.append((name.encode(), code, arr))
    offset_field_positions = []
    for name_b, code, arr in metas:
        header += struct.pack("<I", len(name_b)) + name_b
        header += struct.pack("<II", code, arr.ndim)
        header += struct.pack(f"<{arr.ndim}q", *arr.shape)
        offset_field_positions.append(len(header))
        header += struct.pack("<q", 0)  # placeholder offset
    data_start = (len(header) + 63) // 64 * 64
    offsets = []
    cur = data_start
    for _, _, arr in metas:
        cur = (cur + 63) // 64 * 64
        offsets.append(cur)
        cur += arr.nbytes
    for pos, off in zip(offset_field_positions, offsets):
        header[pos : pos + 8] = struct.pack("<q", off)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(header)
        for (_, _, arr), off in zip(metas, offsets):
            f.seek(off)
            f.write(arr.tobytes())
    os.replace(tmp, path)


class GsbReader:
    """Zero-copy reader; arrays are numpy views into the mmap while open."""

    def __init__(self, path: str):
        self.path = path
        self._lib = _io_library()
        self._handle = self._lib.gsb_open(path.encode())
        if not self._handle:
            raise IOError(f"gaot_io failed to open {path}")

    def read(self, copy: bool = True) -> Dict[str, np.ndarray]:
        if not self._handle:
            raise IOError(f"{self.path} is closed")
        lib = self._lib
        out = {}
        n = lib.gsb_num_arrays(self._handle)
        for i in range(n):
            name = lib.gsb_name(self._handle, i).decode()
            dtype = _DTYPES[lib.gsb_dtype(self._handle, i)]
            ndim = lib.gsb_ndim(self._handle, i)
            dims = [lib.gsb_dims(self._handle, i)[d] for d in range(ndim)]
            nbytes = int(np.prod(dims)) * np.dtype(dtype).itemsize
            buf = (ctypes.c_char * nbytes).from_address(lib.gsb_data(self._handle, i))
            arr = np.frombuffer(buf, dtype=dtype).reshape(dims)
            out[name] = arr.copy() if copy else arr
        return out

    def close(self):
        if self._handle:
            self._lib.gsb_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_gsb_numpy(path: str) -> Dict[str, np.ndarray]:
    """Plain-Python reader of the format (what the native one is held to)."""
    with open(path, "rb") as f:
        blob = f.read()
    assert blob[:4] == b"GSB1", "not a GSB file"
    (n,) = struct.unpack_from("<I", blob, 4)
    cur = 8
    out = {}
    for _ in range(n):
        (name_len,) = struct.unpack_from("<I", blob, cur)
        cur += 4
        name = blob[cur : cur + name_len].decode()
        cur += name_len
        code, ndim = struct.unpack_from("<II", blob, cur)
        cur += 8
        dims = struct.unpack_from(f"<{ndim}q", blob, cur)
        cur += 8 * ndim
        (offset,) = struct.unpack_from("<q", blob, cur)
        cur += 8
        dtype = np.dtype(_DTYPES[code])
        nbytes = int(np.prod(dims)) * dtype.itemsize
        out[name] = np.frombuffer(blob, dtype=dtype, count=int(np.prod(dims)), offset=offset).reshape(dims)
    return out


def pad_batch_native(arrays, counts: np.ndarray, n_pad: int) -> tuple:
    """Threaded native padded-batch assembly for f32 [n_i, C] blocks:
    (out [B, n_pad, C], mask [B, n_pad])."""
    lib = _io_library()
    B = len(arrays)
    C = arrays[0].shape[-1]
    arrays = [np.ascontiguousarray(a, dtype=np.float32) for a in arrays]
    out = np.empty((B, n_pad, C), np.float32)
    mask = np.empty((B, n_pad), np.uint8)
    src_ptrs = (ctypes.c_void_p * B)(
        *[a.ctypes.data_as(ctypes.c_void_p) for a in arrays]
    )
    cnts = (ctypes.c_int64 * B)(*[int(c) for c in counts])
    lib.pad_batch_f32(
        src_ptrs, cnts, B, n_pad, C,
        out.ctypes.data_as(ctypes.c_void_p), mask.ctypes.data_as(ctypes.c_void_p),
    )
    return out, mask.astype(bool)
