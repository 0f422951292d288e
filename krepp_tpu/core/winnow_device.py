"""Fully on-device genome winnowing: minimizers, LSH filter, dedupe, HLL.

The host-compaction path in core/minimizer.py transfers six per-position
arrays per contig to the host. This module keeps the whole pipeline on
device:

  windows -> xur64 -> trailing-window (ldiff) minimizer argmin ->
  LSH residue filter -> (row, residual) sort + neighbour dedupe ->
  HyperLogLog registers via segment_max

and returns only the deduplicated entries (sliced to their true count) plus
two 4096-entry HLL register arrays. Semantics match RSeq::extract_mers
(ref: src/rqseq.cpp:51-144) exactly, including the end-of-sequence emission
over the last `ldiff` *valid* k-mers with its zero-initialised-buffer quirk
(ref: src/rqseq.cpp:67,112-116); 64-bit-hash ties in the window argmin are
broken by position rather than ring-slot order (indistinguishable in
practice).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..params import IndexParams, LSHParams
from . import codec, u64

_U32MAX = jnp.uint32(0xFFFFFFFF)
_HLL_B = 12


def _hll_registers(zlo: jax.Array, mask: jax.Array) -> jax.Array:
    """HyperLogLog register maxima (b=12) of masked uint32 hashes.

    rank = min(32-b, clz(hash << b)) + 1, clz(0) = 32
    (ref: src/hyperloglog.hpp:21,98-105).
    """
    idx = (zlo >> jnp.uint32(32 - _HLL_B)).astype(jnp.int32)
    v = (zlo << jnp.uint32(_HLL_B)).astype(jnp.uint32)
    clz = jax.lax.clz(v.astype(jnp.int32)).astype(jnp.int32)
    clz = jnp.where(v == 0, 32, clz)
    rank = jnp.minimum(32 - _HLL_B, clz) + 1
    rank = jnp.where(mask, rank, 0)
    return jax.ops.segment_max(
        rank.reshape(-1), idx.reshape(-1), num_segments=1 << _HLL_B,
        indices_are_sorted=False)


@functools.partial(jax.jit,
                   static_argnames=("lsh", "w", "r", "frac"))
def winnow_device(codes: jax.Array, n_real: jax.Array, lsh: LSHParams,
                  w: int, r: int, frac: bool,
                  t_lo: jax.Array = None, do_final: jax.Array = None):
    """One padded contig (or halo'd tile) -> deduped (local_row, residual) +
    HLL registers.

    codes: [L] uint8 padded with 4; n_real: real length (int32 scalar).
    For tiles of a chunked long contig, t_lo masks emissions/c1 to window
    positions >= t_lo (the left halo) and do_final gates the end-of-sequence
    emission (last tile only).
    Returns (rows[P+1], res[P+1], nuniq, c1reg[4096], c2reg[4096]) where the
    first nuniq entries of rows/res are the sorted unique kept pairs.
    """
    k = lsh.k
    m = lsh.m
    w = max(w, k)
    ldiff = w - k + 1
    L = codes.shape[-1]
    P = L - k + 1
    t_idx = jnp.arange(P, dtype=jnp.int32)
    if t_lo is None:
        t_lo = jnp.int32(0)
    if do_final is None:
        do_final = jnp.bool_(True)

    valid = codec.window_valid(codes, k) & (t_idx <= n_real - k)
    if w > k:
        vw_full = codec.window_valid(codes, w)
        valid_w = jnp.concatenate(
            [jnp.zeros((w - k,), bool), vw_full], axis=-1) & valid
    else:
        valid_w = valid

    bp_hi, bp_lo = codec.bp64_pair(codes, k)
    z_hi, z_lo = u64.xur64(bp_hi, bp_lo)
    z_hi = jnp.where(valid, z_hi, _U32MAX)
    z_lo = jnp.where(valid, z_lo, _U32MAX)
    rix = codec.lsh_hash_or(codes, lsh)
    res = codec.residual_or(codes, lsh)

    # trailing-window (ldiff) argmin of the 64-bit hash, positional: at any
    # valid_w position the last ldiff k-mer positions are all valid, so the
    # positional window equals the reference's ring buffer of the last
    # ldiff valid k-mers
    best_hi, best_lo = z_hi, z_lo
    best_off = jnp.zeros(P, jnp.int32)
    for s in range(1, ldiff):
        cand_hi = jnp.concatenate([jnp.full((s,), _U32MAX), z_hi[:P - s]])
        cand_lo = jnp.concatenate([jnp.full((s,), _U32MAX), z_lo[:P - s]])
        better = u64.less64(cand_hi, cand_lo, best_hi, best_lo)
        best_hi = jnp.where(better, cand_hi, best_hi)
        best_lo = jnp.where(better, cand_lo, best_lo)
        best_off = jnp.where(better, s, best_off)
    sel = t_idx - best_off
    mrow = rix[sel]
    mres = res[sel]
    mzlo = best_lo  # xur64 low word of the window minimizer

    # end-of-sequence emission: min over the last min(ldiff, total) valid
    # k-mers, zero-entry padded when total < ldiff (zero wins every compare)
    vcum = jnp.cumsum(valid.astype(jnp.int32))
    total = vcum[-1]
    fin_mask = valid & (vcum > total - ldiff)
    zf_hi = jnp.where(fin_mask, z_hi, _U32MAX)
    zf_lo = jnp.where(fin_mask, z_lo, _U32MAX)
    min_hi = jnp.min(zf_hi)
    hi_tie = zf_hi == min_hi
    min_lo = jnp.min(jnp.where(hi_tie, zf_lo, _U32MAX))
    fsel = jnp.argmax(hi_tie & (zf_lo == min_lo))
    zero_entry = total < ldiff
    f_row = jnp.where(zero_entry, jnp.uint32(0), rix[fsel])
    f_res = jnp.where(zero_entry, jnp.uint32(0), res[fsel])
    f_zlo = jnp.where(zero_entry, jnp.uint32(0), z_lo[fsel])
    last_t = jnp.clip(n_real - k, 0, P - 1)
    f_valid = valid[last_t] & (n_real >= k) & do_final

    # LSH residue filter + unified local row (single-partial build scheme,
    # ref: src/rqseq.cpp:125-139)
    def keep_and_local(rr):
        rmod = rr % jnp.uint32(m)
        if frac:
            kp = rmod <= jnp.uint32(r)
            local = (rr // jnp.uint32(m)) * jnp.uint32(r + 1) + rmod
        else:
            kp = rmod == jnp.uint32(r)
            local = rr // jnp.uint32(m)
        return kp, local

    emit = valid & valid_w & (t_idx >= t_lo)
    kp, local = keep_and_local(mrow)
    kp = kp & emit
    fkp, flocal = keep_and_local(f_row)
    fkp = fkp & f_valid

    rows_all = jnp.concatenate([jnp.where(kp, local, _U32MAX),
                                jnp.where(fkp, flocal, _U32MAX)[None]])
    res_all = jnp.concatenate([jnp.where(kp, mres, _U32MAX),
                               jnp.where(fkp, f_res, _U32MAX)[None]])

    srow, sres = jax.lax.sort((rows_all, res_all), num_keys=2)
    prev_row = jnp.concatenate([jnp.array([_U32MAX]), srow[:-1]])
    prev_res = jnp.concatenate([jnp.array([_U32MAX]), sres[:-1]])
    isuniq = (srow != _U32MAX) & ((srow != prev_row) | (sres != prev_res))
    nuniq = jnp.sum(isuniq.astype(jnp.int32))
    # compact unique entries to the front (stable sort by ~uniq)
    order_key = jnp.where(isuniq, jnp.uint32(0), jnp.uint32(1))
    _, crow, cres = jax.lax.sort((order_key, srow, sres), num_keys=1,
                                 is_stable=True)

    c1reg = _hll_registers(z_lo, valid & (t_idx >= t_lo))
    c2_mask = emit
    c2reg = _hll_registers(mzlo, c2_mask)
    f_reg = _hll_registers(f_zlo[None], f_valid[None])
    c2reg = jnp.maximum(c2reg, f_reg)
    return crow, cres, nuniq, c1reg, c2reg


# maximum single-compile tile: one XLA program per power-of-two shape up to
# this; longer contigs are processed in halo-overlapped tiles of this size
_CHUNK = 1 << 20


def _fetch_result(crow, cres, nuniq, c1reg, c2reg):
    nu = int(nuniq)
    # slice to a bucketed length: a distinct slice shape per contig would
    # trigger a fresh XLA compile (~seconds) every time
    step = 1 << 16
    nu_pad = min(((nu + step - 1) // step) * step, crow.shape[0])
    rows, res, c1, c2 = jax.device_get(
        (crow[:nu_pad], cres[:nu_pad], c1reg, c2reg))
    return rows[:nu], res[:nu], c1.astype(np.uint8), c2.astype(np.uint8)


def extract_sequence_mers_device(codes: np.ndarray, params: IndexParams):
    """Device-winnowed equivalent of minimizer.extract_sequence_mers.

    Returns (rows, res, c1reg, c2reg) with rows/res deduplicated, or None
    for contigs shorter than w. Contigs longer than the compile-shape
    budget are tiled with a (w-k)-position halo; tile results are exact
    (each emit position is computed by exactly one tile with its full
    minimizer window in view).
    """
    from .minimizer import _round_len

    n = len(codes)
    if n < params.w:
        return None
    k = params.lsh.k
    w = max(params.w, k)
    ldiff = w - k + 1
    if _round_len(n) <= _CHUNK:
        padded = np.full(_round_len(n), 4, dtype=np.uint8)
        padded[:n] = codes
        out = winnow_device(jnp.asarray(padded), jnp.int32(n), params.lsh,
                            params.w, params.r, params.frac)
        return _fetch_result(*out)

    # ---- chunked path
    left = w - k                      # halo width in window positions
    span = _CHUNK - left - k + 1      # emit positions per tile
    P_global = n - k + 1
    tiles = list(range(0, P_global, span))
    # the end-of-sequence emission needs the last `ldiff` valid k-mers to
    # live inside the final tile; with pathological trailing N-runs they may
    # not — fall back to the exact host path then
    f_start = max(tiles[-1] - left, 0)
    tail = codes[f_start:]
    bad = (tail >= 4).astype(np.int32)
    cbad = np.concatenate([[0], np.cumsum(bad)])
    tail_valid = int(((cbad[k:] - cbad[:-k]) == 0).sum()) if len(tail) >= k else 0
    if tail_valid < ldiff:
        from .hll import HyperLogLog
        from .minimizer import extract_sequence_mers

        rows, res, c1h, c2h = extract_sequence_mers(codes, params)
        key = np.unique(rows.astype(np.uint64) << np.uint64(32) | res)
        h1 = HyperLogLog(_HLL_B)
        h1.add_many(c1h)
        h2 = HyperLogLog(_HLL_B)
        h2.add_many(c2h)
        return ((key >> np.uint64(32)).astype(np.uint32),
                (key & np.uint64(0xFFFFFFFF)).astype(np.uint32), h1.M, h2.M)

    all_rows, all_res = [], []
    c1acc = np.zeros(1 << _HLL_B, np.uint8)
    c2acc = np.zeros(1 << _HLL_B, np.uint8)
    for a in tiles:
        b = min(a + span, P_global)
        start = a - left if a > 0 else 0
        t_lo = a - start
        sl = codes[start: b + k - 1]
        padded = np.full(_CHUNK, 4, dtype=np.uint8)
        padded[: len(sl)] = sl
        is_final = b == P_global
        out = winnow_device(jnp.asarray(padded), jnp.int32(len(sl)),
                            params.lsh, params.w, params.r, params.frac,
                            t_lo=jnp.int32(t_lo),
                            do_final=jnp.bool_(is_final))
        rows, res, c1, c2 = _fetch_result(*out)
        all_rows.append(rows)
        all_res.append(res)
        np.maximum(c1acc, c1, out=c1acc)
        np.maximum(c2acc, c2, out=c2acc)
    rows = np.concatenate(all_rows)
    res = np.concatenate(all_res)
    # cross-tile dedupe (each tile is internally unique already)
    key = np.unique(rows.astype(np.uint64) << np.uint64(32) | res)
    return ((key >> np.uint64(32)).astype(np.uint32),
            (key & np.uint64(0xFFFFFFFF)).astype(np.uint32), c1acc, c2acc)


def extract_genome_mers_device(contigs, params: IndexParams):
    """Winnow a genome on device; returns (rows, res, rho).

    rho is the summed per-sequence HLL-estimate ratio, identical to the
    reference accumulation (ref: src/rqseq.hpp:79) because the register
    maxima match the sequential implementation exactly.
    """
    from .hll import HyperLogLog

    all_rows, all_res = [], []
    n1 = n2 = 0.0
    for codes in contigs:
        out = extract_sequence_mers_device(np.asarray(codes, np.uint8), params)
        if out is None:
            continue
        rows, res, c1, c2 = out
        all_rows.append(rows)
        all_res.append(res)
        h1 = HyperLogLog(_HLL_B)
        h1.M = c1
        h2 = HyperLogLog(_HLL_B)
        h2.M = c2
        n1 += h1.estimate()
        n2 += h2.estimate()
    rows = np.concatenate(all_rows) if all_rows else np.empty(0, np.uint32)
    res = np.concatenate(all_res) if all_res else np.empty(0, np.uint32)
    rho = (n2 / n1) if n1 > 0 else 0.0
    return rows, res, rho
