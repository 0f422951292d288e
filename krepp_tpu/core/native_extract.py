"""ctypes binding for the native genome winnower (csrc/extract.c).

The build-time ingest path (rolling encode + window minimizer + LSH keep,
ref: src/rqseq.cpp:51-144) is host-side, IO-adjacent work, so this native
extractor is the default for `index`/`sketch` builds; the device winnower
(core/winnow_device.py) is the fallback. Semantics are bit-identical to core/minimizer.py (tested).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from typing import Iterable, Optional, Tuple

import numpy as np

from ..params import IndexParams
from .hll import HyperLogLog

_LIB = None
_LOCK = threading.Lock()
_FAILED = False
_HLL_B = 12
# extract.c rejects window spans past its stack rings (MAX_LDIFF_STACK);
# callers route larger w - k + 1 to the device winnower instead.
MAX_LDIFF_STACK = 4096


def _csrc_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "csrc")


def _declare(lib) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.krepp_extract.restype = ctypes.c_int64
    lib.krepp_extract.argtypes = [
        u8p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int32,
        i32p, ctypes.c_int32, i32p, ctypes.c_int32,
        u32p, u32p, u8p, u8p]


def _self_test(lib) -> None:
    """Tiny end-to-end call; catches a stale/foreign .so before first use
    (the .so is a build artifact, never shipped: -march=native output can
    SIGILL on a different host, and mtimes do not survive checkout)."""
    codes = np.arange(40, dtype=np.uint8) % 4
    rows = np.empty(64, np.uint32)
    res = np.empty(64, np.uint32)
    c1 = np.zeros(1 << _HLL_B, np.uint8)
    c2 = np.zeros(1 << _HLL_B, np.uint8)
    ppos = np.arange(5, dtype=np.int32)
    npos = np.arange(5, 19, dtype=np.int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    kept = lib.krepp_extract(
        codes.ctypes.data_as(u8p), len(codes), 19, 25, 1, 0, 0,
        ppos.ctypes.data_as(i32p), len(ppos),
        npos.ctypes.data_as(i32p), len(npos),
        rows.ctypes.data_as(u32p), res.ctypes.data_as(u32p),
        c1.ctypes.data_as(u8p), c2.ctypes.data_as(u8p))
    if not 0 <= kept <= 64:
        raise RuntimeError(f"native extractor self-test returned {kept}")


def get_lib():
    global _LIB, _FAILED
    with _LOCK:
        if _LIB is not None or _FAILED:
            return _LIB
        src = os.path.join(_csrc_dir(), "extract.c")
        try:
            with open(src, "rb") as f:
                tag = hashlib.sha256(f.read()).hexdigest()[:16]
            # rebuild keyed on the source hash (mtimes don't survive git)
            out = os.path.join(_csrc_dir(), f"libextract-{tag}.so")
            if not os.path.exists(out):
                subprocess.run(
                    ["cc", "-O3", "-march=native", "-fPIC", "-shared",
                     "-o", out, src],
                    check=True, capture_output=True, timeout=120)
            lib = ctypes.CDLL(out)
            _declare(lib)
            _self_test(lib)
        except Exception as e:  # noqa: BLE001
            print(f"[krepp-tpu] native extractor build failed ({e}); "
                  "using the JAX winnower", file=sys.stderr)
            _FAILED = True
            return None
        _LIB = lib
        return _LIB


def native_available(params: Optional[IndexParams] = None) -> bool:
    """True when the native path can serve `params` (or any params if None).

    Window spans past the extractor's fixed rings fall back to the device
    winnower rather than hard-failing (csrc/extract.c returns -1 there)."""
    if params is not None and params.w - params.lsh.k + 1 > MAX_LDIFF_STACK:
        return False
    return get_lib() is not None


def extract_sequence_mers_native(codes: np.ndarray, params: IndexParams):
    """One contig -> (rows, res, c1reg, c2reg), or None when len < w.

    Matches minimizer.extract_sequence_mers except the HLL feed is returned
    as registers rather than raw hashes (identical register maxima)."""
    lib = get_lib()
    assert lib is not None
    lsh = params.lsh
    n = len(codes)
    if n < params.w:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    cap = n - lsh.k + 2
    rows = np.empty(cap, np.uint32)
    res = np.empty(cap, np.uint32)
    c1 = np.zeros(1 << _HLL_B, np.uint8)
    c2 = np.zeros(1 << _HLL_B, np.uint8)
    ppos = np.asarray(lsh.ppos, np.int32)
    npos = np.asarray(lsh.npos, np.int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    kept = lib.krepp_extract(
        codes.ctypes.data_as(u8p), n,
        lsh.k, max(params.w, lsh.k),
        lsh.m, params.r, int(params.frac),
        ppos.ctypes.data_as(i32p), len(ppos),
        npos.ctypes.data_as(i32p), len(npos),
        rows.ctypes.data_as(u32p), res.ctypes.data_as(u32p),
        c1.ctypes.data_as(u8p), c2.ctypes.data_as(u8p))
    if kept < 0:
        raise RuntimeError("native extractor failed")
    return rows[:kept].copy(), res[:kept].copy(), c1, c2


def extract_genome_mers_native(contigs: Iterable[np.ndarray],
                               params: IndexParams
                               ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Winnow a genome natively; returns (rows, res, rho).

    rho is the summed per-sequence HLL-estimate ratio, identical to the
    device/host paths (ref: src/rqseq.hpp:79)."""
    all_rows, all_res = [], []
    n1 = n2 = 0.0
    for codes in contigs:
        out = extract_sequence_mers_native(np.asarray(codes, np.uint8),
                                           params)
        if out is None:
            continue
        rows, res, c1, c2 = out
        all_rows.append(rows)
        all_res.append(res)
        h1 = HyperLogLog(_HLL_B)
        h1.M = c1
        n1 += h1.estimate()
        h2 = HyperLogLog(_HLL_B)
        h2.M = c2
        n2 += h2.estimate()
    rows = np.concatenate(all_rows) if all_rows else np.empty(0, np.uint32)
    res = np.concatenate(all_res) if all_res else np.empty(0, np.uint32)
    rho = (n2 / n1) if n1 > 0 else 0.0
    return rows, res, rho
