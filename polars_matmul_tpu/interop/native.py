"""Loader for the C++ native marshaling library (ctypes C ABI).

The shared object is built from the committed ``native/pmm_native.cpp``
on first use, if a compiler is available, into ``build/native/`` of the
checkout (``make native`` does the same).  Its file name carries a hash of
the source and the host architecture, and it is compiled for the
architecture's baseline instruction set, so a build never runs on a host
or against a source it was not made for.  Every entry point has a
pure-NumPy fallback, so the package works (slower on ragged List inputs)
without a toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
from typing import Optional

import numpy as np

log = logging.getLogger("polars_matmul_tpu")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "pmm_native.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")

_lib = None
_tried = False


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(
        _BUILD_DIR, f"pmm_native-{digest}-{platform.machine()}.so")


def _build(so: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    # -fno-math-errno only drops errno bookkeeping (results unchanged)
    cmd = ["g++", "-O3", "-fno-math-errno", "-shared", "-fPIC",
           "-std=c++17", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
        return True
    except (OSError, subprocess.SubprocessError) as e:  # pragma: no cover
        log.debug("native build failed: %s", e)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SRC):
        return None
    so = _so_path()
    if not os.path.exists(so) and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:  # pragma: no cover
        return None

    i64 = ctypes.c_int64
    p = ctypes.POINTER
    lib.pmm_pack_list_f32.restype = ctypes.c_int
    lib.pmm_pack_list_f32.argtypes = [
        p(ctypes.c_float), p(ctypes.c_int64), ctypes.c_void_p, i64, i64,
        p(ctypes.c_float),
    ]
    lib.pmm_pack_list_f64.restype = ctypes.c_int
    lib.pmm_pack_list_f64.argtypes = [
        p(ctypes.c_double), p(ctypes.c_int64), ctypes.c_void_p, i64, i64,
        p(ctypes.c_double),
    ]
    lib.pmm_half_to_float.restype = None
    lib.pmm_half_to_float.argtypes = [
        p(ctypes.c_uint16), p(ctypes.c_float), i64,
    ]
    lib.pmm_assemble_topk.restype = None
    lib.pmm_assemble_topk.argtypes = [
        p(ctypes.c_int32), p(ctypes.c_float), i64, i64,
        p(ctypes.c_uint32), p(ctypes.c_double),
    ]
    if hasattr(lib, "pmm_quantize_i8"):
        lib.pmm_quantize_i8.restype = None
        lib.pmm_quantize_i8.argtypes = [
            p(ctypes.c_float), i64, i64, p(ctypes.c_int8),
            p(ctypes.c_float),
        ]
    if hasattr(lib, "pmm_quantize_i4"):
        lib.pmm_quantize_i4.restype = None
        lib.pmm_quantize_i4.argtypes = [
            p(ctypes.c_float), i64, i64, i64, i64, p(ctypes.c_int8),
            p(ctypes.c_float),
        ]
    _lib = lib
    return _lib


def native_pack_list(
    values: np.ndarray,
    offsets: np.ndarray,
    validity: Optional[np.ndarray],
    n_rows: int,
    dim: int,
) -> Optional[np.ndarray]:
    """Dense-pack a ragged list column via the C++ kernel.

    ``validity`` is a boolean per-row array (or None).  Returns None when the
    native library is unavailable (caller falls back to NumPy), raises on
    dimension mismatch.
    """
    lib = get_lib()
    if lib is None:
        return None
    dtype = values.dtype
    if dtype == np.float32:
        fn, ctype = lib.pmm_pack_list_f32, ctypes.c_float
    elif dtype == np.float64:
        fn, ctype = lib.pmm_pack_list_f64, ctypes.c_double
    else:
        return None

    values = np.ascontiguousarray(values)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    out = np.empty((n_rows, dim), dtype=dtype)

    vbits_ptr = None
    if validity is not None:
        vbits = np.packbits(
            np.ascontiguousarray(validity, dtype=np.uint8), bitorder="little"
        )
        vbits_ptr = vbits.ctypes.data_as(ctypes.c_void_p)

    rc = fn(
        values.ctypes.data_as(ctypes.POINTER(ctype)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vbits_ptr,
        n_rows,
        dim,
        out.ctypes.data_as(ctypes.POINTER(ctype)),
    )
    if rc != 0:
        raise ValueError(
            "Dimension mismatch: ragged List rows have inconsistent lengths"
        )
    return out


def native_quantize_i8(c: np.ndarray):
    """Fused one-pass per-row symmetric int8 quantization via the C++
    kernel.  Returns (codes (n, dim) i8, scales (n,) f32), or None when
    the native library is unavailable or dtype isn't f32 (caller falls
    back to the NumPy path — the two produce bit-identical results)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "pmm_quantize_i8") \
            or c.dtype != np.float32:
        return None
    c = np.ascontiguousarray(c)
    n, dim = c.shape
    codes = np.empty((n, dim), np.int8)
    scales = np.empty(n, np.float32)
    lib.pmm_quantize_i8(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, dim,
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        scales.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return codes, scales


def native_quantize_i4(c: np.ndarray, ck: int, dpp: int):
    """Fused one-pass per-row int4 quantize + nibble-pack via the C++
    kernel (layout contract: kernels/fused_topk.py::quantize_int4).
    Returns (packed (n, dpp//2) i8, scales (n,) f32) or None for the
    NumPy fallback — the two are bit-identical."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "pmm_quantize_i4") \
            or c.dtype != np.float32:
        return None
    c = np.ascontiguousarray(c)
    n, dim = c.shape
    packed = np.empty((n, dpp // 2), np.int8)
    scales = np.empty(n, np.float32)
    lib.pmm_quantize_i4(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, dim, ck, dpp,
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        scales.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return packed, scales


def native_available() -> bool:
    return get_lib() is not None
