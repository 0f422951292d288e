"""Minimizer winnowing + LSH subsampling for reference-genome sketching.

Replicates the semantics of RSeq::extract_mers (ref: src/rqseq.cpp:51-144):
for every position where the trailing run of ACGT bases reaches w (or at the
final base of the sequence with a run >= k), emit the k-mer minimising
xur64(bp64) among the last `ldiff = w-k+1` *valid* k-mers seen; keep it when
LSH(x) mod m (<=|==) r; estimate the subsampling rate rho as the ratio of
per-sequence HyperLogLog estimates (distinct minimizers / distinct k-mers),
summed over sequences (ref: src/rqseq.cpp:63-64,142-143, src/rqseq.hpp:79).

Reference quirks reproduced deliberately:
  * the minimizer ring buffer is zero-initialised; an end-of-sequence emission
    before ldiff valid k-mers have been seen selects a zero entry, i.e. the
    all-A k-mer with row 0 / residual 0 (ref: src/rqseq.cpp:67,112-116);
  * after an N-base resets the run, an end-of-sequence emission may select a
    stale pre-N k-mer still in the buffer (same lines);
  * sequences shorter than w are skipped entirely, including their HLL
    contribution (ref: src/rqseq.hpp:80-86).

Design: all per-position work (validity, bp packing, xur64, LSH row,
residual) is computed on device as statically-shifted slice sums
(see core/codec.py); the data-dependent compaction and trailing-window
argmin run on host in vectorized numpy. The device part is a parallel scan
over the whole contig — the reference's sequential rolling encode has no
loop-carried dependence here.
"""

from __future__ import annotations

import functools
from typing import Iterable, List

import jax
import jax.numpy as jnp
import numpy as np

from ..params import IndexParams, LSHParams
from . import codec, u64
from .hll import HyperLogLog


@functools.partial(jax.jit, static_argnames=("lsh", "w"))
def _window_stats(codes: jax.Array, lsh: LSHParams, w: int):
    """Per-window quantities for one (batch of) contig(s).

    Returns (valid_k, valid_w, z_hi, z_lo, rix, res), each [..., P] with
    P = L - k + 1; valid_w[t] is False for t < w - k.
    """
    k = lsh.k
    valid_k = codec.window_valid(codes, k)
    if w > k:
        vw_full = codec.window_valid(codes, w)  # [..., L - w + 1]
        pad = jnp.zeros(codes.shape[:-1] + (w - k,), dtype=bool)
        valid_w = jnp.concatenate([pad, vw_full], axis=-1)
    else:
        valid_w = valid_k
    bp_hi, bp_lo = codec.bp64_pair(codes, k)
    z_hi, z_lo = u64.xur64(bp_hi, bp_lo)
    rix = codec.lsh_hash_or(codes, lsh)
    res = codec.residual_or(codes, lsh)
    return valid_k, valid_w, z_hi, z_lo, rix, res


def _round_len(n: int) -> int:
    """Bucket contig lengths to limit jit recompiles.

    Pure powers of two: at most ~20 shapes (and compiles) can ever exist;
    the <=2x padding is cheap device work.
    """
    return 1 << max(8, (n - 1).bit_length())


def extract_sequence_mers(codes: np.ndarray, params: IndexParams):
    """Winnow one contig. Returns (rows, res, c1_hashes, c2_hashes) or None.

    rows/res: kept (local-row, residual) pairs, uint32. c1/c2: low-32-bit
    xur64 hashes feeding the per-sequence HLL counters.
    """
    lsh = params.lsh
    k, w = lsh.k, max(params.w, lsh.k)
    n = len(codes)
    if n < params.w:  # ref: src/rqseq.hpp:80-86 (set_curr_seq)
        return None
    ldiff = w - k + 1
    padded = np.full(_round_len(n), 4, dtype=np.uint8)
    padded[:n] = codes
    P = len(padded) - k + 1
    valid_k, valid_w, z_hi, z_lo, rix, res = (
        np.asarray(x) for x in _window_stats(jnp.asarray(padded), lsh, w))
    Pn = n - k + 1  # windows fully inside the real sequence
    valid_k = valid_k[:Pn]
    valid_w = valid_w[:Pn]

    z64 = (z_hi.astype(np.uint64) << np.uint64(32)) | z_lo.astype(np.uint64)

    V = np.flatnonzero(valid_k)  # compacted valid k-mer positions
    if V.size == 0:
        return (np.empty(0, np.uint32), np.empty(0, np.uint32),
                np.empty(0, np.uint32), np.empty(0, np.uint32))

    # emit rule (ref: src/rqseq.cpp:112-116): l >= w, or final base with l >= k
    emit = valid_w[V].copy()
    if V[-1] == Pn - 1:
        emit[-1] = True

    zv = z64[V]
    # trailing window min of width ldiff over the compacted array, with
    # zero-entry padding before the start (zero-initialised ring buffer)
    zpad = np.concatenate([np.zeros(ldiff - 1, np.uint64), zv])
    sw = np.lib.stride_tricks.sliding_window_view(zpad, ldiff)  # [nv, ldiff]
    amin = np.argmin(sw, axis=1)  # first minimum ~ reference's min_element
    sel_c = np.arange(V.size) - (ldiff - 1) + amin  # compacted idx, <0 => zero entry

    e_idx = np.flatnonzero(emit)
    sel_e = sel_c[e_idx]
    is_zero_entry = sel_e < 0
    sel_pos = V[np.maximum(sel_e, 0)]
    mrix = np.where(is_zero_entry, np.uint32(0), rix[sel_pos]).astype(np.uint32)
    mres = np.where(is_zero_entry, np.uint32(0), res[sel_pos]).astype(np.uint32)
    mz_lo = np.where(is_zero_entry, np.uint32(0), z_lo[sel_pos]).astype(np.uint32)

    m, r, frac = lsh.m, params.r, params.frac
    rmod = mrix % np.uint32(m)
    keep = (rmod <= np.uint32(r)) if frac else (rmod == np.uint32(r))
    if frac:
        local = (mrix // np.uint32(m)) * np.uint32(r + 1) + rmod
    else:
        local = mrix // np.uint32(m)

    c1 = z_lo[V].astype(np.uint32)  # all valid k-mers (ref: src/rqseq.cpp:110)
    c2 = mz_lo                      # every emitted minimizer (ref: :117)
    return local[keep].astype(np.uint32), mres[keep], c1, c2


def extract_genome_mers(contigs: Iterable[np.ndarray], params: IndexParams):
    """Winnow a whole genome (iterable of contig code arrays).

    Returns (rows, res, rho): deduplicated is NOT applied here (the table
    build sorts/dedupes per row, ref: src/table.cpp:248-260); rho is the
    summed-HLL estimate ratio (ref: src/rqseq.hpp:79).
    """
    all_rows: List[np.ndarray] = []
    all_res: List[np.ndarray] = []
    n1_est = 0.0
    n2_est = 0.0
    for codes in contigs:
        out = extract_sequence_mers(np.asarray(codes, dtype=np.uint8), params)
        if out is None:
            continue
        rows, res, c1h, c2h = out
        all_rows.append(rows)
        all_res.append(res)
        h1 = HyperLogLog(12)
        h1.add_many(c1h)
        h2 = HyperLogLog(12)
        h2.add_many(c2h)
        n1_est += h1.estimate()
        n2_est += h2.estimate()
    rows = np.concatenate(all_rows) if all_rows else np.empty(0, np.uint32)
    res = np.concatenate(all_res) if all_res else np.empty(0, np.uint32)
    rho = (n2_est / n1_est) if n1_est > 0 else 0.0
    return rows, res, rho
