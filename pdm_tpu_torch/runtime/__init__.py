"""Native host-side data runtime (C++ via ctypes) with numpy fallbacks.

A port-local copy of ``pdm_tpu/runtime``: the same C source
(``native/pdm_runtime.cpp``) and the same numpy fallbacks for a host
without a compiler. The library is built with ``g++`` at first use, never
at import, into ``pdm_tpu_torch/_build/`` under a name keyed by the
source's and flags' hash (so an edited source never loads a stale build).
Concurrent first uses (several test workers) each build to a private name
and rename it into place.

This is host code: it decodes uint8 images to [-1, 1] fp32 CHW, resizes
them, and gathers minibatch rows into a staging buffer
(``utils.data.HostResidentData``). The PDMC cache format is the JAX
package's, so either package reads a cache the other wrote.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "native" / "pdm_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
build_error: Optional[str] = None  # why the native path is unavailable

_i64 = ctypes.c_int64
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(["g++", *CXX_FLAGS]).encode())
    return BUILD_DIR / f"libpdm_runtime-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                   check=True, capture_output=True, text=True)
    os.replace(tmp, path)


def _declare(lib: ctypes.CDLL) -> None:
    lib.pdm_normalize_u8_hwc_to_f32_chw.argtypes = [
        _u8p, _f32p, _i64, _i64, _i64, _i64]
    lib.pdm_normalize_u8_hwc_to_f32_chw.restype = None
    lib.pdm_resize_bilinear_u8.argtypes = [
        _u8p, _u8p, _i64, _i64, _i64, _i64, _i64, _i64]
    lib.pdm_resize_bilinear_u8.restype = None
    lib.pdm_gather_rows_f32.argtypes = [_f32p, _i64p, _f32p, _i64, _i64]
    lib.pdm_gather_rows_f32.restype = None
    lib.pdm_gather_rows_u8_to_f32.argtypes = [_u8p, _i64p, _f32p, _i64, _i64]
    lib.pdm_gather_rows_u8_to_f32.restype = None
    lib.pdm_stream_mean.argtypes = [
        _f32p, _i64, _i64, _f64p, ctypes.POINTER(_i64)]
    lib.pdm_stream_mean.restype = None
    lib.pdm_version.argtypes = []
    lib.pdm_version.restype = _i64


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on first call; None (and
    ``build_error`` set) when no compiler can build it."""
    global _lib, _build_failed, build_error
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = library_path()
        try:
            if not path.exists():
                _build(path)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError:
                # a library another machine built (another libc): rebuild
                _build(path)
                lib = ctypes.CDLL(str(path))
            _declare(lib)
        except (OSError, AttributeError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", "") or ""
            build_error = f"{type(e).__name__}: {e} {detail}".strip()
            _build_failed = True
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# public ops (native path + numpy fallback)
# ---------------------------------------------------------------------------


def normalize_u8_to_chw_f32(images: np.ndarray) -> np.ndarray:
    """(N, H, W, C) uint8 -> (N, C, H, W) float32 in [-1, 1]."""
    images = np.ascontiguousarray(images, dtype=np.uint8)
    n, h, w, c = images.shape
    lib = get_lib()
    if lib is not None:
        out = np.empty((n, c, h, w), np.float32)
        lib.pdm_normalize_u8_hwc_to_f32_chw(images, out, n, h, w, c)
        return out
    return np.transpose(
        images.astype(np.float32) * (2.0 / 255.0) - 1.0, (0, 3, 1, 2)
    )


def resize_bilinear_u8(images: np.ndarray, h_out: int, w_out: int) -> np.ndarray:
    """(N, H, W, C) uint8 -> (N, h_out, w_out, C) uint8 (align-corners
    bilinear)."""
    images = np.ascontiguousarray(images, dtype=np.uint8)
    n, h, w, c = images.shape
    if (h, w) == (h_out, w_out):
        return images
    lib = get_lib()
    if lib is not None:
        out = np.empty((n, h_out, w_out, c), np.uint8)
        lib.pdm_resize_bilinear_u8(images, out, n, h, w, h_out, w_out, c)
        return out
    ys = np.linspace(0, h - 1, h_out)
    xs = np.linspace(0, w - 1, w_out)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[None, :, None, None]
    wx = (xs - x0)[None, None, :, None]
    img = images.astype(np.float32)
    top = img[:, y0][:, :, x0] * (1 - wx) + img[:, y0][:, :, x1] * wx
    bot = img[:, y1][:, :, x0] * (1 - wx) + img[:, y1][:, :, x1] * wx
    return (top * (1 - wy) + bot * wy + 0.5).astype(np.uint8)


def gather_rows(data: np.ndarray, idx: np.ndarray,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """out[i] = data[idx[i]] for a host matrix (fp32 or uint8 source;
    uint8 decodes to [-1, 1] fp32 on the fly). ``out``, when given, is a
    C-contiguous fp32 buffer of exactly len(idx) rows."""
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    rows = idx.shape[0]
    row_elems = int(np.prod(data.shape[1:]))
    flat = data.reshape(data.shape[0], row_elems)
    if rows and (idx.min() < 0 or idx.max() >= data.shape[0]):
        raise IndexError(f"gather_rows: indices outside [0, {data.shape[0]})")
    if out is None:
        out = np.empty((rows, row_elems), np.float32)
    elif out.size != rows * row_elems or out.dtype != np.float32 or not (
            out.flags["C_CONTIGUOUS"]):
        raise ValueError(
            f"gather_rows: out must be a C-contiguous float32 buffer of "
            f"{rows}*{row_elems} elements (the native kernel writes exactly "
            f"that), got {out.dtype} {out.shape}")
    out2 = out.reshape(rows, row_elems)
    lib = get_lib()
    if lib is not None and flat.flags["C_CONTIGUOUS"] and flat.dtype in (
            np.float32, np.uint8):
        if flat.dtype == np.float32:
            lib.pdm_gather_rows_f32(flat, idx, out2, rows, row_elems)
        else:
            lib.pdm_gather_rows_u8_to_f32(flat, idx, out2, rows, row_elems)
    elif flat.dtype == np.uint8:
        out2[:] = flat[idx].astype(np.float32) * (2.0 / 255.0) - 1.0
    else:
        out2[:] = flat[idx].astype(np.float32)
    return out2.reshape(rows, *data.shape[1:])


# ---------------------------------------------------------------------------
# memory-mapped dataset cache
# ---------------------------------------------------------------------------

_MAGIC = b"PDMC0001"


def write_cache(path: str, array: np.ndarray) -> None:
    """Binary cache: 8-byte magic, header length, int64 header (dtype code,
    ndim, shape), raw data. Memory-mappable for instant re-ingest."""
    dtype_code = {np.dtype(np.uint8): 0, np.dtype(np.float32): 1}[array.dtype]
    with open(path, "wb") as f:
        f.write(_MAGIC)
        header = np.array([dtype_code, array.ndim, *array.shape], np.int64)
        f.write(np.array([header.size], np.int64).tobytes())
        f.write(header.tobytes())
        f.write(np.ascontiguousarray(array).tobytes())


def read_cache(path: str, mmap: bool = True) -> np.ndarray:
    with open(path, "rb") as f:
        if f.read(8) != _MAGIC:
            raise ValueError(f"not a PDMC cache: {path}")
        (hsize,) = np.frombuffer(f.read(8), np.int64)
        header = np.frombuffer(f.read(8 * int(hsize)), np.int64)
        offset = f.tell()
    dtype = {0: np.uint8, 1: np.float32}[int(header[0])]
    shape = tuple(int(s) for s in header[2: 2 + int(header[1])])
    if mmap:
        return np.memmap(path, dtype=dtype, mode="r", offset=offset, shape=shape)
    with open(path, "rb") as f:
        f.seek(offset)
        return np.frombuffer(f.read(), dtype=dtype).reshape(shape)
