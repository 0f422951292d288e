"""ctypes binding for the native parallel radix sort (csrc/sortkv.c).

The global sort-and-group index union (build.py) is the accelerator-friendly
replacement for the reference's locked union tree
(ref: src/krepp.cpp:248-303); at tens of millions of tuples numpy's
single-threaded comparison sort dominates the build, so the key/payload
sort runs through this OpenMP LSD radix when the toolchain is available.
Falls back to numpy transparently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from typing import Optional, Tuple

import numpy as np

_LIB = None
_LOCK = threading.Lock()
_FAILED = False


def _csrc_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "csrc")


def _self_test(lib) -> None:
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2**63, 1000).astype(np.uint64)
    v = np.arange(1000, dtype=np.uint32)
    ks = np.sort(k)
    vs = v[np.argsort(k, kind="stable")]
    rc = lib.krepp_sort_kv(
        k.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(1000))
    if rc != 0 or not (np.array_equal(k, ks) and np.array_equal(v, vs)):
        raise RuntimeError("native sort self-test failed")


def get_lib():
    global _LIB, _FAILED
    with _LOCK:
        if _LIB is not None or _FAILED:
            return _LIB
        src = os.path.join(_csrc_dir(), "sortkv.c")
        try:
            with open(src, "rb") as f:
                tag = hashlib.sha256(f.read()).hexdigest()[:16]
            out = os.path.join(_csrc_dir(), f"libsortkv-{tag}.so")
            if not os.path.exists(out):
                subprocess.run(
                    ["cc", "-O3", "-march=native", "-fopenmp", "-fPIC",
                     "-shared", "-o", out, src],
                    check=True, capture_output=True, timeout=120)
            lib = ctypes.CDLL(out)
            lib.krepp_sort_kv.restype = ctypes.c_int64
            lib.krepp_sort_kv.argtypes = [
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64]
            lib.krepp_sort_k.restype = ctypes.c_int64
            lib.krepp_sort_k.argtypes = [
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64]
            lib.krepp_pack_keys.restype = None
            lib.krepp_pack_keys.argtypes = [
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64]
            lib.krepp_sort_unique_pairs.restype = ctypes.c_int64
            lib.krepp_sort_unique_pairs.argtypes = [
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64]
            lib.krepp_pack_codes.restype = ctypes.c_int64
            lib.krepp_pack_codes.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32)]
            _self_test(lib)
        except Exception as e:  # noqa: BLE001
            print(f"[krepp-tpu] native sort build failed ({e}); "
                  "using numpy sorts", file=sys.stderr)
            _FAILED = True
            return None
        _LIB = lib
        return _LIB


def sort_kv(keys: np.ndarray, vals: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Stable ascending sort of (u64 keys, u32 payload). Returns sorted
    copies (native in-place on copies, or the numpy fallback)."""
    assert keys.dtype == np.uint64 and len(keys) == len(vals)
    lib = get_lib()
    if lib is None or len(keys) < (1 << 16):
        order = np.argsort(keys, kind="stable")
        return keys[order], vals[order]
    k = np.ascontiguousarray(keys, np.uint64).copy()
    v = np.ascontiguousarray(vals, np.uint32).copy()
    rc = lib.krepp_sort_kv(
        k.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(len(k)))
    if rc != 0:
        order = np.argsort(keys, kind="stable")
        return keys[order], vals[order]
    return k, v


def pack_codes(codes: np.ndarray, lengths: np.ndarray):
    """Native 2-bit read packing; returns (packed, vbits | None) or None
    when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    B, L = codes.shape
    W = (L + 15) // 16
    WV = (L + 31) // 32
    codes_c = np.ascontiguousarray(codes, np.uint8)
    lengths_c = np.ascontiguousarray(lengths, np.int32)
    packed = np.empty((B, W), np.uint32)
    vbits = np.empty((B, WV), np.uint32)
    n_inv = lib.krepp_pack_codes(
        codes_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(B), ctypes.c_int64(L),
        lengths_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        vbits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return packed, (vbits if n_inv else None)


def pack_keys(rows: np.ndarray, res: np.ndarray) -> np.ndarray:
    """(row, residual) u32 pairs -> u64 keys row<<32|res."""
    lib = get_lib()
    if lib is None or len(rows) < (1 << 16):
        return rows.astype(np.uint64) << np.uint64(32) | res.astype(np.uint64)
    rows = np.ascontiguousarray(rows, np.uint32)
    res = np.ascontiguousarray(res, np.uint32)
    out = np.empty(len(rows), np.uint64)
    lib.krepp_pack_keys(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        res.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(len(rows)))
    return out


def sort_unique_pairs(rows: np.ndarray, res: np.ndarray,
                      inplace: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted dedupe of (row, residual) pairs (per-genome dedupe,
    ref: src/table.cpp:157-166). Returns unique pairs in key order.

    inplace=True permutes the caller's arrays (callers owning freshly
    extracted buffers skip one copy per genome)."""
    lib = get_lib()
    if lib is None:
        key = np.unique(rows.astype(np.uint64) << np.uint64(32)
                        | res.astype(np.uint64))
        return ((key >> np.uint64(32)).astype(np.uint32),
                (key & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    r = np.ascontiguousarray(rows, np.uint32)
    s = np.ascontiguousarray(res, np.uint32)
    if not inplace:
        r = r.copy() if r is rows else r
        s = s.copy() if s is res else s
    m = lib.krepp_sort_unique_pairs(
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(len(r)))
    if m < 0:
        key = np.unique(rows.astype(np.uint64) << np.uint64(32)
                        | res.astype(np.uint64))
        return ((key >> np.uint64(32)).astype(np.uint32),
                (key & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return r[:m], s[:m]


def sort_k(keys: np.ndarray) -> np.ndarray:
    """Ascending sort of u64 keys."""
    assert keys.dtype == np.uint64
    lib = get_lib()
    if lib is None or len(keys) < (1 << 16):
        return np.sort(keys, kind="stable")
    k = np.ascontiguousarray(keys, np.uint64).copy()
    if lib.krepp_sort_k(
            k.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.c_int64(len(k))) != 0:
        return np.sort(keys, kind="stable")
    return k
