"""Query engines: batched LSH probe + histogram + ML distance on device.

Pipeline (replacing the reference's per-read, per-k-mer branchy loops,
ref: src/query.cpp:40-94,352-390):

  stage 1 (int32, device): for every (read, position, strand) compute the
    LSH row + residual, slice the bucket from the flat CSR, compute Hamming
    distances to all entries, and OR together the leaf bitmasks of matching
    colors per distance value. A segment-min over distance then yields, for
    each (read, leaf, strand), the histogram of per-position minimum
    distances — the order-independent reformulation of Minfo::update_match
    (ref: src/query.hpp:153-176).

  stage 2 (f64): apply the hdist_filt candidate filter
    (ref: src/query.cpp:96-139), run the batched Brent ML solver per
    (read, leaf, strand), and resolve strands.

  stage 3 (place only): ancestor accumulation as a dense damping-weight
    matmul over the flattened placement tree + candidate stats
    (ref: src/query.cpp:218-333).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import codec
from .bucket_scan import (make_expander, probe_strand,
                          probe_strand_full, scan_buckets_min)
from ..core.llh import (make_llh, make_llh_fast, brent_find_minima,
                        brent_on_mask, F)
from ..index.index import DeviceIndex, DeviceSketch

HD_SENTINEL = 255          # "no match" Hamming distance marker
D_MAX = np.finfo(np.float64).max  # Minfo d_llh default (ref: src/query.hpp:226)


def _f64_segment_min(dm, keep, seg, NB, lb):
    """Segment-min of the kept f64 lanes over sorted segment ids.

    Returns (cand [NB] f64 — D_MAX where no lane is kept, +inf for a
    segment without lanes — and the per-lane `at` mask marking kept lanes
    equal to their segment's min)."""
    cand = jax.ops.segment_min(jnp.where(keep, dm, jnp.float64(D_MAX)), seg,
                               num_segments=NB, indices_are_sorted=True)
    return cand, keep & (dm == cand[lb])


def _f64_segment_select(x, mask, seg, NB):
    """The single mask-marked f64 lane of each segment (callers guarantee
    <= 1 set lane per segment; segments with none return 0 — gate on your
    own has-contributor mask). A sum of one term is exact."""
    return jax.ops.segment_sum(jnp.where(mask, x, 0.0), seg,
                               num_segments=NB, indices_are_sorted=True)


def _csr_bucket_slices(row_start, row_ids, urow, resident):
    """(start, cnt) per probe from a dense or sparse-row CSR.

    Sparse tables (huge LSH row spaces, index.SPARSE_ROW_THRESHOLD) binary-
    search the sorted nonempty-row ids instead of indexing a dense offset
    array (ref dense scheme: src/table.hpp:121-136).
    """
    if row_ids is None:
        start = row_start[urow]
        cnt = jnp.where(resident, row_start[urow + 1] - start, 0)
        return start, cnt
    i = jnp.searchsorted(row_ids, urow)
    i = jnp.minimum(i, row_ids.shape[0] - 1).astype(jnp.int32)
    found = resident & (row_ids[i] == urow)
    start = row_start[i]
    cnt = jnp.where(found, row_start[i + 1] - start, 0)
    return start, cnt


# Dense slots materialized per bucket row in hybrid mode. Gather bytes grow
# with the row width, so the dense row holds only the first DENSE_SLOTS
# entries (+ a count word); deeper buckets are rescanned through the CSR by
# the compacted heavy tail. The epilogue's cost scales with the slot count.
DENSE_SLOTS = 2
# Heavy-tail capacity fallback divisor (used only when index statistics are
# unavailable): K = max(4096, nprobes // HEAVY_DIV). The production cap is
# sized from the index's own bucket-depth histogram at load time
# (_measure_heavy_frac) — a fixed divisor tuned on one world cliffed 8.5x
# on the reference-default h=13 world.
HEAVY_DIV = 32
# Safety margin over the modeled heavy-lane rate; a miss costs one 4x-cap
# tier re-run, never a full-batch exact rescan.
HEAVY_SAFETY = 1.5
# Weight of the entry-weighted (exact-match k-mer) row distribution in the
# heavy-lane model; mutated/foreign k-mers hash ~uniformly over rows.
EXACT_MIX = 0.35
# Heavy-tail buckets up to this depth are rescanned with ONE unrolled
# padded gather (no while_loop); only deeper buckets (vanishing at
# winnowed-index statistics) take the sequential scan loop.
TAIL_UNROLL = 16
# Second-stage compaction cap divisor for those ultra-deep buckets.
DEEP_DIV = 256
# Device-memory budget for the dense bucket-row table.
DIRECT_MEM_CAP = 2 << 30
# Embed the leaf bitmask next to each residual only while it is this narrow
# (<= EMBED_W_CAP u32 words, i.e. <= 64 leaf slots); wider indexes store the
# color id instead and gather the mask from the se table — one extra gather,
# but the bucket-row table stays O(entries), independent of the leaf count.
EMBED_W_CAP = 2
# SeekEngine's direct table is full-width (no CSR heavy tail behind it), so
# it only pays off for shallow sketches; deeper ones scan the CSR.
SEEK_DIRECT_CAP = 16


def hybrid_flavor(nrows: int, max_bucket: int, W: int,
                  mem_cap: int = DIRECT_MEM_CAP) -> Optional[str]:
    """Pick the hybrid bucket-row flavor that fits mem_cap (None if none)."""
    C0 = min(DENSE_SLOTS, max(1, max_bucket))
    if W <= EMBED_W_CAP and nrows * (1 + C0 * (1 + W)) * 4 <= mem_cap:
        return "embed"
    if nrows * (1 + 2 * C0) * 4 <= mem_cap:
        return "se"
    return None


def build_hybrid_slots(row_start: np.ndarray, enc_v: np.ndarray,
                       se_v: np.ndarray, se_mask: np.ndarray,
                       nrows_dense, max_bucket: int, W: int,
                       mem_cap: int = DIRECT_MEM_CAP,
                       flavor: Optional[str] = None):
    """Build the hybrid bucket-row table over one CSR (shared by the
    single-device and per-shard table builds).

    nrows_dense: the dense row count, or None for a sparse (nonempty-rows
    + trailing zero row) table. flavor forces a layout (per-shard tables
    must agree across shards). Returns (slots u32 [nrows, width], flavor)
    or (None, None) when no flavor fits mem_cap."""
    C0 = min(DENSE_SLOTS, max(1, max_bucket))
    ncontent = len(row_start) - 1
    nrows = ncontent if nrows_dense is not None else ncontent + 1
    assert nrows_dense is None or nrows_dense == ncontent
    if flavor is None:
        flavor = hybrid_flavor(nrows, max_bucket, W, mem_cap)
    if flavor is None:
        return None, None
    width = 1 + C0 * (1 + W) if flavor == "embed" else 1 + 2 * C0
    counts = np.diff(row_start)
    slots = np.zeros((nrows, width), np.uint32)
    slots[:ncontent, 0] = counts.astype(np.uint32)
    row_of = np.repeat(np.arange(ncontent, dtype=np.int64), counts)
    j = (np.arange(len(enc_v), dtype=np.int64)
         - np.repeat(row_start[:-1], counts))
    first = j < C0
    rows_d = row_of[first]
    jd = j[first]
    if flavor == "embed":
        col = (1 + jd * (1 + W)).astype(np.int64)
        slots[rows_d, col] = enc_v[first]
        mask_rows = se_mask[se_v[first]]
        for wd in range(W):
            slots[rows_d, col + 1 + wd] = mask_rows[:, wd]
    else:
        slots[rows_d, 1 + jd] = enc_v[first]
        slots[rows_d, 1 + C0 + jd] = se_v[first].astype(np.uint32)
    return slots, flavor


class QueryEngine:
    """dist/place probe + leaf-level ML over one DeviceIndex.

    Probe layouts (chosen at init):
      * 'hybrid' — a bucket-row table (count word + first C0 entries per
        row, leaf bitmask embedded or color id stored): a probe is ONE row
        gather + the fused epilogue;
        deep buckets spill to a compacted CSR rescan. Sparse row spaces
        route through a binary search of the nonempty-row ids.
      * 'event' — many-genome indexes (no bitmask table): matched events
        expand through the per-color leaf-slot CSR and dedupe by sort
        (see event_probe.py). Chosen when the index skipped its bitmasks
        or KREPP_EVENT_PROBE=1.
      * 'csr' — flat entry array + offset CSR with a bounded scan loop and
        a compacted heavy tail (fallback when no bucket-row table fits).

    All large index arrays are passed to the jitted programs as arguments
    (never closure constants): constants would be embedded in every compiled
    program and its cache entry.
    """

    def __init__(self, dindex: DeviceIndex, hdist_th: int = 4):
        self.di = dindex
        self.th = int(hdist_th)
        self.lsh = dindex.lsh
        self.S = dindex.nleafslots
        self.W = (dindex.se_mask.shape[1] if dindex.se_mask is not None
                  else (self.S + 31) // 32)
        self._rho_slot = jnp.asarray(dindex.rho_slot)
        self._expand = make_expander(self.S, self.W)
        self._llh = make_llh(self.lsh.k, self.lsh.h, self.th)
        self._llh_fast = make_llh_fast(self.lsh.k, self.lsh.h, self.th)
        # residue -> (resident, rank) maps are tiny; applied as elementwise
        # select chains (a gather, however small, costs a dispatch)
        self._res_resident = [bool(b) for b in dindex.resident]
        self._res_rank = [int(r) for r in dindex.res_rank]
        # probe epilogue: "compiled" runs the Triton kernel (on a GPU, where
        # it beat the XLA formulation end to end, PERF.md), "interpret" the
        # same kernel in the Pallas interpreter (tests), None the XLA
        # formulation (every other backend, and the kernel's reference)
        self.epilogue_kernel = ("compiled" if jax.default_backend() == "gpu"
                                else None)
        import os

        # many-genome indexes skip the bitmask tables entirely and probe
        # through match events (exact; parity-tested on forced small worlds)
        self._use_event = (dindex.se_mask is None
                           or bool(os.environ.get("KREPP_EVENT_PROBE")))
        self._heavy_frac = self._measure_heavy_frac(dindex)
        self._init_tables(dindex)
        self._full_jits = {}

    @staticmethod
    def _measure_heavy_frac(di: DeviceIndex) -> float:
        """Expected fraction of probe lanes whose bucket exceeds the dense
        slots, from the index's own bucket-depth histogram.

        Two probe populations bound the rate: k-mers present in the index
        land on rows entry-weighted (exact-match reads), while mutated or
        foreign k-mers hash ~uniformly over the unified row space. The cap
        covers max(uniform, EXACT_MIX * entry-weighted) of resident lanes
        with a HEAVY_SAFETY margin. Reference bar: the full-depth bucket
        scan has no capacity at all (src/table.hpp:121-136)."""
        C0 = min(DENSE_SLOTS, max(1, di.max_bucket))
        counts = np.diff(di.row_start)
        total = int(counts.sum())
        if total == 0 or di.max_bucket <= C0:
            return 0.0
        heavy = counts > C0
        entry_frac = float(counts[heavy].sum()) / total
        rand_frac = float(np.count_nonzero(heavy)) / max(int(di.nrows_u), 1)
        res_frac = (float(np.count_nonzero(di.resident))
                    / max(len(di.resident), 1))
        return min(0.5, HEAVY_SAFETY * res_frac
                   * max(rand_frac, EXACT_MIX * entry_frac))

    def _heavy_caps(self, Np: int, tier: int):
        """(K, K2): heavy-tail and ultra-deep compaction caps for Np probe
        lanes at a capacity tier (4x per tier, like the event caps)."""
        frac = getattr(self, "_heavy_frac", 0.0)
        K0 = int(np.ceil(Np * frac)) if frac > 0 else Np // HEAVY_DIV
        K0 = max(4096, K0)
        ov = getattr(self, "_heavy_cap_override", None)
        if ov is not None:   # test hook: force tiny caps to drive escalation
            K0 = ov
        K = min(Np, K0 << (2 * tier))
        K2 = min(K, max(256 if ov is None else 1, Np // DEEP_DIV)
                 << (2 * tier))
        return K, K2

    # --------------------------------------------------------- table builds
    def _init_tables(self, dindex: DeviceIndex) -> None:
        """Choose the probe layout and place its arrays on device.

        Overridden by ShardedQueryEngine, which shards its own arrays."""
        csr = self._csr_arrays(dindex)
        if self._use_event:
            self.mode = "event"
            # single-device event mode stays in lane form end to end
            # (no [B, S, X] histogram); the sharded engine overrides this
            # (its per-shard dense histograms psum exactly)
            self._event_lanes = True
            self.C0 = min(DENSE_SLOTS, max(1, dindex.max_bucket))
            slots, _ = build_hybrid_slots(
                dindex.row_start, dindex.enc_v, dindex.se_v, None,
                dindex.nrows_u if dindex.row_ids is None else None,
                max(1, dindex.max_bucket), self.W, flavor="se")
            assert slots is not None, \
                "bucket-row table exceeds the memory cap; shard the index"
            heavy_tab = None
            if dindex.max_bucket > self.C0:
                heavy_tab = self._build_heavy_tab(dindex, slots, aux="se")
            self._tables = (jnp.asarray(slots),) + csr[:3] + (
                jnp.asarray(dindex.leaf_csr_off),
                jnp.asarray(dindex.leaf_csr_slots), heavy_tab)
            return
        slots, flavor = self._build_hybrid_table(dindex)
        if slots is not None:
            self.mode = "hybrid"
            self.hflavor = flavor
            self.C0 = min(DENSE_SLOTS, max(1, dindex.max_bucket))
            heavy_tab = None
            if dindex.max_bucket > self.C0:
                heavy_tab = self._build_heavy_tab(dindex, slots)
            self._tables = (jnp.asarray(slots),) + csr + (heavy_tab,)
        else:
            self.mode = "csr"
            self._tables = csr

    # Budget for the heavy-bucket side table; deeper buckets than fit take
    # the bounded CSR scan loop.
    HEAVY_TAB_CAP = 512 << 20

    def _build_heavy_tab(self, di: DeviceIndex, slots: np.ndarray,
                         aux: str = "auto"):
        """Side table with one padded row per heavy bucket (depth > C0):
        word 0 = true count, then TP (enc, mask-word | se) entry pairs
        covering bucket entries [0, TP). The owning slots row's count word
        is patched to min(cnt, 255) | (heavy_id + 1) << 8, so the probe
        reaches the whole tail with ONE random single-row gather — no
        row_start routing, and no consecutive-entry gather.
        Returns None (CSR fallback) when the id doesn't fit 24 bits or the
        table would exceed HEAVY_TAB_CAP at a useful depth."""
        counts = np.diff(di.row_start)
        heavy = np.flatnonzero(counts > self.C0)
        n_h = len(heavy)
        if n_h == 0 or n_h >= (1 << 24) - 1:
            return None
        # row width from the measured depth distribution: cover 99.9% of
        # heavy buckets AND 99.5% of their entry mass (probe probability is
        # ~entry-weighted for exact-match reads); the rare deeper buckets
        # take the bounded CSR scan. A fixed TAIL_UNROLL width doubled the
        # heavy-row gather bytes on lambda ~1-2 indexes for a tail that is
        # practically never populated.
        hc = counts[heavy]
        q_row = float(np.quantile(hc, 0.999))
        hs = np.sort(hc)
        wcum = np.cumsum(hs, dtype=np.float64)
        q_mass = float(hs[min(np.searchsorted(wcum, 0.995 * wcum[-1]),
                              len(hs) - 1)])
        TP = int(np.ceil(max(q_row, q_mass)))
        TP = min(max(TP, 4), int(di.max_bucket), TAIL_UNROLL)
        while TP > 4 and n_h * (1 + 2 * TP) * 4 > self.HEAVY_TAB_CAP:
            TP -= 1
        if n_h * (1 + 2 * TP) * 4 > self.HEAVY_TAB_CAP:
            return None
        htab = np.zeros((n_h, 1 + 2 * TP), np.uint32)
        htab[:, 0] = counts[heavy].astype(np.uint32)
        starts = di.row_start[heavy]
        ends = di.row_start[heavy + 1]
        use_mask = (aux == "auto" and self.W == 1
                    and di.se_mask is not None)
        for j in range(TP):
            pos = starts + j
            valid = pos < ends
            pv = np.where(valid, pos, 0)
            htab[:, 1 + 2 * j] = np.where(valid, di.enc_v[pv], 0)
            if use_mask:
                av = di.se_mask[di.se_v[pv]][:, 0]
            else:
                av = di.se_v[pv].astype(np.uint32)
            htab[:, 2 + 2 * j] = np.where(valid, av, 0)
        slots[heavy, 0] = (np.minimum(counts[heavy], 255).astype(np.uint32)
                           | ((np.arange(n_h, dtype=np.uint32) + 1) << 8))
        return jnp.asarray(htab)

    def _csr_arrays(self, dindex: DeviceIndex):
        enc_se = np.stack(
            [dindex.enc_v, dindex.se_v.astype(np.uint32)], axis=1)
        row_start = dindex.row_start.astype(
            np.int32 if dindex.row_start[-1] < 2**31 else np.int64)
        row_ids = (None if dindex.row_ids is None
                   else dindex.row_ids.astype(np.int32))
        return (jnp.asarray(enc_se), jnp.asarray(row_start),
                None if row_ids is None else jnp.asarray(row_ids),
                None if dindex.se_mask is None
                else jnp.asarray(dindex.se_mask))

    def _build_hybrid_table(self, di: DeviceIndex):
        """Dense bucket-row table: one u32 row per (unified | nonempty) LSH
        row; word 0 = count, then C0 slots. Two flavors:

          'embed' — each slot is (enc, mask W words); one gather per probe.
          'se'    — slots are enc * C0 then se * C0; the mask is gathered
                    from the se table afterwards. Row width is independent
                    of the leaf count, so wide indexes (many genomes) and
                    huge row spaces stay within the memory cap.

        Sparse row spaces (di.row_ids set) build the table over nonempty
        rows only, + one all-zero row at the end for missed probes; the
        probe routes through a binary search of row_ids first.
        Buckets deeper than C0 spill to the CSR heavy tail."""
        return build_hybrid_slots(
            di.row_start, di.enc_v, di.se_v, di.se_mask,
            di.nrows_u if di.row_ids is None else None,
            max(1, di.max_bucket), self.W)

    # ------------------------------------------------- residue select chains
    def _residue_maps(self, rix):
        """rix [., ...] uint32 -> (resident bool, rank int32), gather-free."""
        m = self.lsh.m
        rmod = (rix % jnp.uint32(m)).astype(jnp.int32)
        resident = jnp.zeros(rmod.shape, bool)
        rank = jnp.zeros(rmod.shape, jnp.int32)
        for r in range(m):
            if self._res_resident[r]:
                hit = rmod == r
                resident = resident | hit
                if self._res_rank[r] > 0:
                    rank = jnp.where(hit, self._res_rank[r], rank)
        return resident, rank

    # ------------------------------------------------------------- stage 1
    def _urow(self, rix, valid):
        """Unified row + residency per probe, gather-free."""
        resident, rank = self._residue_maps(rix)
        resident = resident & valid
        urow = (rix // jnp.uint32(self.lsh.m)).astype(jnp.int32) * self.di.R \
            + rank
        return jnp.where(resident, urow, 0), resident

    def _bucket_slices_t(self, tables, rix, valid):
        """LSH row -> (start, cnt) bucket slice per probe (CSR mode)."""
        _, row_start, row_ids, _ = tables
        urow, resident = self._urow(rix, valid)
        return _csr_bucket_slices(row_start, row_ids, urow, resident)

    def _strand_probe(self, tables, rix, res, valid, exact: bool = False):
        enc_se, _, _, mask_tab = tables
        start, cnt = self._bucket_slices_t(tables, rix, valid)
        if exact:
            hist, minall = probe_strand_full(
                enc_se, mask_tab, self._expand, start, cnt, res,
                self.th, self.W, self.S, self.di.max_bucket)
            return hist, minall, jnp.bool_(False)
        return probe_strand(enc_se, mask_tab, self._expand, start,
                            cnt, res, self.th, self.W, self.S,
                            self.di.max_bucket)

    def _strand_hashes(self, codes, lengths):
        lsh = self.lsh
        k = lsh.k
        P = codes.shape[1] - k + 1
        t_idx = jnp.arange(P, dtype=jnp.int32)
        rix_or, rix_rc, res_or, res_rc, valid_w = \
            codec.strand_hashes_conv(codes, lsh)
        valid = valid_w & (t_idx[None, :] <= lengths[:, None] - k)
        onmers = jnp.sum(valid, axis=1, dtype=jnp.int32)
        rix2 = jnp.stack([rix_or, rix_rc])
        res2 = jnp.stack([res_or, res_rc])
        return rix2, res2, valid, onmers

    def _packed_epilogue_ok(self, P: int) -> bool:
        """Gate for the packed-counter Pallas epilogue: <= 6 distance
        classes, per-read position counts that fit its 8-bit counters, and
        a leaf loop short enough to unroll."""
        from .pallas_kernels import MAX_LEAVES

        return (self.epilogue_kernel is not None and self.th + 1 <= 6
                and P <= 255 and self.S <= MAX_LEAVES)

    def _dense_epilogue(self, d, mask_tab, res2, light, B, P):
        """First-C0-slot probe epilogue -> (hist [2B,S,X], minall [2B]).

        d: gathered bucket rows [2, B, P, width]. The packed-counter
        kernel when _packed_epilogue_ok, else the XLA formulation below
        (the reference the kernel is tested against)."""
        th, W, S, C0 = self.th, self.W, self.S, self.C0
        X = th + 1
        N = 2 * B
        ent4 = self._hybrid_ent4(d, mask_tab, N, P)
        if self._packed_epilogue_ok(P):
            from .pallas_kernels import probe_hist_packed

            ents = [ent4[..., c, j] for c in range(C0) for j in range(1 + W)]
            return probe_hist_packed(
                res2.reshape(N, P), light.reshape(N, P), ents, th, C0, W, S,
                interpret=self.epilogue_kernel == "interpret")
        enc = ent4[..., 0]                               # [N, P, C0]
        msk = ent4[..., 1:]                              # [N, P, C0, W]
        has = jnp.zeros(enc.shape, bool)
        for wd in range(W):
            has = has | (msk[..., wd] != 0)
        hd = codec.hdist_lr32(enc, res2.reshape(N, P)[..., None])
        match = has & (hd <= th) & light.reshape(N, P)[..., None]
        gmin = jnp.min(jnp.where(match, hd, HD_SENTINEL), axis=-1)
        minall = jnp.min(gmin, axis=-1)                  # [N]
        seen = None
        hists = []
        for x in range(X):
            hit = match & (hd == x)
            plane = jnp.zeros(enc.shape[:-1] + (W,), jnp.uint32)
            for c in range(C0):
                plane = plane | jnp.where(hit[..., c, None], msk[..., c, :], 0)
            bits = self._expand(plane)                   # [N, P, S]
            if seen is None:
                new = bits
                seen = bits
            else:
                new = bits & (seen ^ jnp.uint32(1))
                seen = seen | bits
            hists.append(jnp.sum(new.astype(jnp.int32), axis=1))
        hist = jnp.stack(hists, axis=-1)                 # [N, S, X]
        return hist, minall

    def _route_rows(self, row_ids, urow, resident):
        """urow -> (sidx into the slots table, hrow into row_start, found).

        Dense tables address slots/row_start by urow directly; sparse ones
        binary-search the sorted nonempty-row ids, sending missed probes to
        the table's trailing all-zero row."""
        if row_ids is None:
            return urow, urow, resident
        nnz = row_ids.shape[0]
        pos = jnp.searchsorted(row_ids, urow).astype(jnp.int32)
        posc = jnp.minimum(pos, nnz - 1)
        found = resident & (row_ids[posc] == urow)
        sidx = jnp.where(found, posc, nnz)
        return sidx, posc, found

    def _hybrid_ent4(self, d, mask_tab, N, P):
        """Slot row payload -> [N, P, C0, 1+W] (enc, mask words) entries."""
        C0, W = self.C0, self.W
        if self.hflavor == "embed":
            return d[..., 1:].reshape(N, P, C0, 1 + W)
        enc = d[..., 1: 1 + C0].reshape(N, P, C0)
        se = d[..., 1 + C0:].reshape(N, P, C0).astype(jnp.int32)
        return jnp.concatenate([enc[..., None], mask_tab[se]], axis=-1)

    def _hybrid_core(self, slots_d, enc_se, row_start, mask_tab, sidx, hrow,
                     resident, res2, max_bucket: int, tier: int = 0,
                     heavy_tab=None):
        """Shared hybrid probe body over pre-routed rows.

        sidx/hrow/resident/res2: [2, B, P]. Returns (hist [2B, S, X],
        minall [2B], overflow). Used by the single-device probe and, with
        shard-local routing, by each shard under shard_map (which passes
        heavy_tab=None and takes the CSR tail)."""
        th, W, S, C0 = self.th, self.W, self.S, self.C0
        X = th + 1
        _, B, P = sidx.shape
        N = 2 * B
        d = slots_d[sidx]                                # [2, B, P, width]
        word0 = d[..., 0].astype(jnp.int32)
        # with a heavy table the count word packs cnt | (hid+1) << 8
        cnt_c = word0 & 255 if heavy_tab is not None else word0
        cnt = jnp.where(resident, cnt_c, 0)
        heavy = cnt > C0
        light = resident & jnp.logical_not(heavy)
        hist, minall = self._dense_epilogue(d, mask_tab, res2, light, B, P)

        overflow = jnp.bool_(False)
        if max_bucket > C0:
            from ..core.compact import (compact_mask_indices,
                                        compact_mask_indices_strided)

            Np = N * P
            K, K2 = self._heavy_caps(Np, tier)
            hf = heavy.reshape(Np)
            hidx, nheavy, blk_over = compact_mask_indices_strided(hf, K)
            overflow = (nheavy > K) | blk_over
            # compacted indices are already ascending => seg sorted; the
            # compaction emits only set lanes, so hidx < Np marks live
            seg = jnp.minimum(hidx // P, N - 1).astype(jnp.int32)
            live = hidx < Np
            safe_l = jnp.minimum(hidx, Np - 1)
            hres = res2.reshape(N, P).reshape(Np)[safe_l]
            nk = max(enc_se.shape[0], 1)
            start = None
            if heavy_tab is not None:
                # heavy-bucket table: one single-row gather per heavy lane
                # fetches (count, first TP entries). Replaces the
                # row_start/hurow routing gathers AND the [K, MB]
                # consecutive-entry gather.
                nh = heavy_tab.shape[0]
                MB = (heavy_tab.shape[1] - 1) // 2
                hid = jnp.clip((word0.reshape(Np)[safe_l] >> 8) - 1,
                               0, nh - 1)
                hrow_t = heavy_tab[hid]                  # [K, 1 + 2*MB]
                hcnt = jnp.where(live, hrow_t[:, 0].astype(jnp.int32), 0)
                penc = hrow_t[:, 1::2]                   # [K, MB]
                aux = hrow_t[:, 2::2]                    # mask word | se
                jj = jnp.arange(MB, dtype=jnp.int32)
                hd = codec.hdist_lr32(penc, hres[:, None])
                inb = jj[None, :] < jnp.minimum(hcnt, MB)[:, None]
                match = inb & (hd <= th)
                if W == 1:
                    msk = jnp.where(match[..., None], aux[..., None],
                                    jnp.uint32(0))       # [K, MB, 1]
                else:
                    sev = jnp.where(match, aux, 0).astype(jnp.int32)
                    msk = mask_tab[sev]                  # [K, MB, W]
            else:
                # CSR tail: route through row_start (sharded path, and the
                # fallback when the heavy table exceeds its budget)
                hurow = hrow.reshape(Np)[safe_l]
                start = row_start[hurow]
                hcnt = jnp.where(live, (row_start[hurow + 1] - start),
                                 0).astype(jnp.int32)
                MB = min(max_bucket, TAIL_UNROLL)
                jj = jnp.arange(MB, dtype=jnp.int32)
                idx = jnp.minimum(start[:, None] + jj[None, :], nk - 1)
                pair = enc_se[idx]                       # [K, MB, 2]
                hd = codec.hdist_lr32(pair[..., 0], hres[:, None])
                inb = jj[None, :] < jnp.minimum(hcnt, MB)[:, None]
                match = inb & (hd <= th)
                sev = jnp.where(match, pair[..., 1], 0).astype(jnp.int32)
                msk = mask_tab[sev]                      # [K, MB, W]
            Mm = []
            for x in range(X):
                hitx = (match & (hd == x))[..., None]
                sel = jnp.where(hitx, msk, 0)
                plane = sel[:, 0]
                for j in range(1, MB):   # OR: one bucket may repeat colors
                    plane = plane | sel[:, j]
                Mm.append(plane)
            Mm = jnp.stack(Mm)                           # [X, K, W]
            hgmin = jnp.min(jnp.where(match, hd, HD_SENTINEL), axis=1)

            if max_bucket > MB:
                # tier B: ultra-deep buckets finish with the scan loop
                from .bucket_scan import _scan_loop

                deep = live & (hcnt > MB)
                didx, ndeep = compact_mask_indices(deep, K2)
                overflow = overflow | (ndeep > K2)
                dsafe = jnp.minimum(didx, K - 1)
                dlive = didx < K
                if start is None:
                    hurow_d = hrow.reshape(Np)[safe_l[dsafe]]
                    start_d = row_start[hurow_d]
                else:
                    start_d = start[dsafe]
                dcnt = jnp.where(dlive, hcnt[dsafe], 0)
                Mm20 = jnp.zeros((X, K2, W), jnp.uint32)
                gmin20 = jnp.full((K2,), HD_SENTINEL, jnp.int32)
                hmax = jnp.minimum(jnp.max(dcnt), max_bucket)
                Mm2, gmin2 = _scan_loop(enc_se, mask_tab, start_d,
                                        dcnt, hres[dsafe], th, W, MB, hmax,
                                        Mm20, gmin20)
                for x in range(X):
                    merged = Mm[x].at[dsafe].set(
                        jnp.where(dlive[:, None], Mm[x][dsafe] | Mm2[x],
                                  Mm[x][dsafe]), mode="drop",
                        unique_indices=True)
                    Mm = Mm.at[x].set(merged)
                hgmin = hgmin.at[dsafe].min(
                    jnp.where(dlive, gmin2, HD_SENTINEL), mode="drop")
            if X <= 6 and P <= 255:
                # packed-counter aggregation (same base-256 scheme as the
                # packed Pallas epilogue): per-(lane, leaf) minimum class,
                # classes 0-2 at bits 0/8/16 of word 0, 3-5 of word 1 —
                # TWO sorted segment-sums instead of X (the scatter-adds
                # dominated the tail at X=5)
                mh = jnp.full((K, S), X, jnp.int32)
                for x in range(X - 1, -1, -1):
                    bits = self._expand(Mm[x])           # [K, S] 0/1
                    mh = jnp.where(bits != 0, x, mh)
                w_live = live.astype(jnp.int32)[:, None]
                sh0 = jnp.minimum(8 * mh, 24)
                sh1 = jnp.clip(8 * (mh - 3), 0, 24)
                e0 = jnp.where(mh < 3, jnp.int32(1) << sh0, 0) * w_live
                e1 = jnp.where((mh >= 3) & (mh < X),
                               jnp.int32(1) << sh1, 0) * w_live
                p0 = jax.ops.segment_sum(e0, seg, num_segments=N,
                                         indices_are_sorted=True)
                p1 = jax.ops.segment_sum(e1, seg, num_segments=N,
                                         indices_are_sorted=True)
                # one stacked add: X separate .at[:, :, x].add updates each
                # re-materialized the full [N, S, X] histogram
                planes = []
                for x in range(X):
                    w = p0 if x < 3 else p1
                    off = 8 * x if x < 3 else 8 * (x - 3)
                    planes.append((w >> off) & jnp.int32(255))
                hist = hist + jnp.stack(planes, axis=-1)
            else:
                seen = None
                w_live = live.astype(jnp.uint32)
                for x in range(X):
                    bits = self._expand(Mm[x])           # [K, S]
                    if seen is None:
                        new = bits
                        seen = bits
                    else:
                        new = bits & (seen ^ jnp.uint32(1))
                        seen = seen | bits
                    contrib = (new * w_live[:, None]).astype(jnp.int32)
                    hist = hist.at[:, :, x].add(jax.ops.segment_sum(
                        contrib, seg, num_segments=N,
                        indices_are_sorted=True))
            hgmin = jnp.where(live, hgmin, HD_SENTINEL)
            minh = jax.ops.segment_min(hgmin, seg, num_segments=N,
                                       indices_are_sorted=True)
            minall = jnp.minimum(minall, jnp.minimum(minh, HD_SENTINEL))
        return hist, minall, overflow

    def _probe_hybrid(self, tables, codes, lengths, tier: int = 0):
        """Dense-2 bucket-row probe + compacted CSR heavy tail, always exact
        up to the stats-sized heavy-tail capacity (overflow -> 4x-cap tier
        re-runs, then the exact full rescan as a last resort).

        Semantics identical to the CSR scan: per-(read, position, leaf)
        minimum Hamming distance histogram (ref: src/query.hpp:153-176).
        The dense row carries a count word and the first DENSE_SLOTS
        entries; probes hitting deeper buckets are excluded from the dense
        pass and rescanned at full depth through the CSR."""
        slots_d, enc_se, row_start, row_ids, mask_tab, heavy_tab = tables
        rix2, res2, valid, onmers = self._strand_hashes(codes, lengths)
        urow, resident = self._urow(rix2, valid[None])   # [2, B, P]
        sidx, hrow, resident = self._route_rows(row_ids, urow, resident)
        hist, minall, overflow = self._hybrid_core(
            slots_d, enc_se, row_start, mask_tab, sidx, hrow, resident,
            res2, self.di.max_bucket, tier, heavy_tab)
        B = codes.shape[0]
        hist = hist.reshape(2, B, self.S, self.th + 1)
        minall = minall.reshape(2, B)
        return (hist[0], hist[1], minall[0], minall[1], onmers, overflow)

    def _event_caps(self, B: int, P: int, tier: int):
        """Capacity tier for the event probe; each tier 16x the last.

        Overflowing batches re-run at the next tier (fetch_prefetched), so
        caps bound memory, never results. Tier-0 sizing: many-genome
        indexes run denser than the small-S hybrid worlds (lambda ~2
        entries/row at the reference defaults on 1000 genomes puts ~8% of
        probes past the dense slots), so the heavy cap is Np/8 — r03's
        Np/16 made EVERY production batch escalate a tier. The leaf-event
        buffer at Np/8 covers measured hit rates with two strands and
        hdist_th; match-dense batches pay one escalated re-run instead of
        every batch paying 16x padding."""
        Np = 2 * B * P
        rf = self._res_frac()
        E = min(8 << (2 * tier), max(self.di.max_bucket, 1))
        KH = min(Np, max(4096, int(Np * rf) // 4) << (2 * tier))
        CAP_L = max(1 << 16, int(Np * rf) // 4) << (2 * tier)
        return E, KH, CAP_L

    def _res_frac(self) -> float:
        """Fraction of probe lanes whose LSH residue is resident (exact:
        rows hash ~uniformly over the m residues)."""
        m = max(self.lsh.m, 1)
        return sum(1 for r in self._res_resident if r) / m

    def _resident_cap(self, Np: int):
        """Static capacity for the resident-lane compaction (None = skip):
        resident lanes are ~Binomial(Np, res_frac), so a 1.02x + 8k margin
        sits far above any realizable draw; a miss only costs a tier
        re-run via the overflow flag."""
        rf = self._res_frac()
        if rf >= 0.95:
            return None
        KR = int(Np * rf * 1.02) + 8192
        return min(Np, (KR + 1023) & ~1023)

    def _probe_event(self, tables, codes, lengths, tier: int):
        """Event-formulated probe (see event_probe.py): exact, O(S)-free."""
        from .event_probe import event_probe

        (slots_d, enc_se, row_start, row_ids, leaf_off, leaf_slots,
         heavy_tab) = tables
        rix2, res2, valid, onmers = self._strand_hashes(codes, lengths)
        urow, resident = self._urow(rix2, valid[None])   # [2, B, P]
        sidx, hrow, resident = self._route_rows(row_ids, urow, resident)
        B, P = codes.shape[0], urow.shape[2]
        E, KH, CAP_L = self._event_caps(B, P, tier)
        hist, minall, ov = event_probe(
            slots_d, enc_se, row_start, leaf_off, leaf_slots,
            sidx, hrow, resident, res2, self.th, self.C0, self.S,
            self.di.max_bucket, E, KH, CAP_L, heavy_tab=heavy_tab)
        hist = hist.reshape(2, B, self.S, self.th + 1)
        minall = minall.reshape(2, B)
        return (hist[0], hist[1], minall[0], minall[1], onmers, ov)

    def _probe_csr_exact(self, tables, codes, lengths):
        """Exact full-depth CSR scan of every probe (overflow fallback)."""
        enc_se, row_start, row_ids, mask_tab = tables[1:5] \
            if self.mode == "hybrid" else tables[-4:]
        rix2, res2, valid, onmers = self._strand_hashes(codes, lengths)
        urow, resident = self._urow(rix2, valid[None])
        start, cnt = _csr_bucket_slices(row_start, row_ids, urow, resident)
        B = codes.shape[0]
        P = urow.shape[2]
        N = 2 * B
        hist, minall = probe_strand_full(
            enc_se, mask_tab, self._expand, start.reshape(N, P),
            cnt.reshape(N, P), res2.reshape(N, P),
            self.th, self.W, self.S, self.di.max_bucket)
        hist = hist.reshape(2, B, self.S, self.th + 1)
        minall = minall.reshape(2, B)
        return (hist[0], hist[1], minall[0], minall[1], onmers,
                jnp.bool_(False))

    def _probe_impl(self, tables, codes, lengths, exact: bool = False,
                    tier: int = 0):
        if self.mode == "event":
            # "exact" maps to a high capacity tier; true cap escalation is
            # host-driven in fetch_prefetched
            return self._probe_event(tables, codes, lengths,
                                     max(tier, 2) if exact else tier)
        if self.mode == "hybrid":
            if exact:
                return self._probe_csr_exact(tables, codes, lengths)
            return self._probe_hybrid(tables, codes, lengths, tier)
        lsh = self.lsh
        k = lsh.k
        B, L = codes.shape
        P = L - k + 1
        t_idx = jnp.arange(P, dtype=jnp.int32)
        rix_or, rix_rc, res_or, res_rc, valid_w = \
            codec.strand_hashes_conv(codes, lsh)
        valid = valid_w & (t_idx[None, :] <= lengths[:, None] - k)
        onmers = jnp.sum(valid, axis=1, dtype=jnp.int32)

        hist_or, minall_or, ov1 = self._strand_probe(tables, rix_or, res_or,
                                                     valid, exact)
        hist_rc, minall_rc, ov2 = self._strand_probe(tables, rix_rc, res_rc,
                                                     valid, exact)
        return hist_or, hist_rc, minall_or, minall_rc, onmers, ov1 | ov2

    # ------------------------------------------------------------- stage 2
    def _optimize(self, hist, uc, rho):
        def f(d):
            return self._llh(d, hist, uc, rho)

        return brent_find_minima(f, uc.shape)

    def _stage2_lanes(self, hist_or, hist_rc, minall_or, minall_rc, onmers,
                      leaf_ok, K: int):
        """Leaf-level filtering + ML + strand resolution on COMPACTED match
        lanes (ref: src/query.cpp:96-139).

        Dense, stage 2 is O(S) f64 work per read, and at many-genome scale
        almost every (read, leaf) lane is empty (a 150 bp read matches a
        handful of leaves). Lanes
        with any match on either strand are compacted to K slots, every
        f64 op (Brent, likelihoods, strand picks) runs lane-wise, and the
        per-read closest scan becomes sorted-segment reductions. Values are
        the dense formulation's, element for element; n_lanes > K raises
        the overflow flag and the driver re-runs at full capacity.
        """
        from ..core.compact import compact_mask_indices

        B = hist_or.shape[0]
        S = self.S
        BS = B * S
        X = self.th + 1

        # counts are tiny; the CPU/x64 epilogue may deliver int64
        hist_or = hist_or.astype(jnp.int32)
        hist_rc = hist_rc.astype(jnp.int32)
        mc_or_d = jnp.sum(hist_or, axis=-1, dtype=jnp.int32)  # [B, S]
        mc_rc_d = jnp.sum(hist_rc, axis=-1, dtype=jnp.int32)
        anym = (mc_or_d > 0) | (mc_rc_d > 0)
        idx, nset = compact_mask_indices(anym.reshape(-1), K)
        lane_over = nset > K
        lv = idx < BS
        safe = jnp.minimum(idx, BS - 1)
        h_or = jnp.where(lv[:, None], hist_or.reshape(BS, X)[safe], 0)
        h_rc = jnp.where(lv[:, None], hist_rc.reshape(BS, X)[safe], 0)
        return self._stage2_core(idx, lv, h_or, h_rc, minall_or, minall_rc,
                                 onmers, leaf_ok, lane_over)

    def _stage2_core(self, idx, lv, h_or, h_rc, minall_or, minall_rc,
                     onmers, leaf_ok, lane_over):
        """Lane-form stage 2 on pre-extracted (read, leaf) lanes.

        idx: [K] int32 ascending b*S+s keys (sentinel B*S for empty);
        h_or/h_rc: [K, X] int32 per-strand first-match histograms."""
        th = self.th
        X = th + 1
        B = minall_or.shape[0]
        S = self.S
        BS = B * S
        NB = B + 1
        K = idx.shape[0]
        xs = jnp.arange(X, dtype=jnp.int32)

        safe = jnp.minimum(idx, BS - 1)
        lb = safe // S                                        # owning read
        ls = safe - lb * S                                    # leaf slot
        seg = jnp.where(lv, lb, B)                            # sorted ids
        lok = leaf_ok[ls]
        mc_or = jnp.sum(h_or, axis=-1, dtype=jnp.int32)
        mc_rc = jnp.sum(h_rc, axis=-1, dtype=jnp.int32)

        def leaf_stats(h, mc, minall):
            present = (mc > 0) & lok
            minhd = jnp.min(jnp.where(h > 0, xs[None, :], HD_SENTINEL),
                            axis=-1)
            filt = jnp.where(minall < HD_SENTINEL, 2 * minall + 1,
                             jnp.int32(2 * HD_SENTINEL))
            keep = present & (minhd <= filt[lb])
            return keep

        keep_or = leaf_stats(h_or, mc_or, minall_or)
        keep_rc = leaf_stats(h_rc, mc_rc, minall_rc)

        onm_l = onmers[lb]
        uc_or = (onm_l - mc_or).astype(F)
        uc_rc = (onm_l - mc_rc).astype(F)
        rho_l = self._rho_slot[ls].astype(F)
        # histogram moments in exact int32 (counts and x are tiny)
        bx_or = jnp.sum(h_or * xs[None, :], axis=-1,
                        dtype=jnp.int32).astype(F)
        bx_rc = jnp.sum(h_rc * xs[None, :], axis=-1,
                        dtype=jnp.int32).astype(F)
        A2 = jnp.concatenate([mc_or.astype(F), mc_rc.astype(F)])
        Bx2 = jnp.concatenate([bx_or, bx_rc])
        uc2 = jnp.concatenate([uc_or, uc_rc])
        rho2 = jnp.concatenate([rho_l, rho_l])
        # the solver runs up to ~45 serialized iterations; run it only on
        # strand-lanes that pass the hdist_filt keep gate — on real data roughly half the 2K
        # strand-lanes are the wrong orientation (A = 0 junk) and lanes
        # beyond the match count are padding. brent_on_mask compacts into
        # the smallest capacity tier that fits (2K/4, 2K/2, dense), each
        # lane's trajectory unchanged (lanes are independent).
        keep2 = jnp.concatenate([keep_or, keep_rc])
        d2, v2 = brent_on_mask(self._llh_fast, A2, Bx2, uc2, rho2, keep2,
                               cap_divisors=(4, 2))
        d_or = jnp.where(keep_or, d2[:K], D_MAX)
        d_rc = jnp.where(keep_rc, d2[K:], D_MAX)
        v_or = jnp.where(keep_or, v2[:K], 0.0)
        v_rc = jnp.where(keep_rc, v2[K:], 0.0)

        # strand choice for the resolved map (ref: src/query.cpp:126-134):
        # the rc entry is replaced by the or-version when the or strand
        # compares better; a filtered-out or entry carries d = DBL_MAX
        # exactly as the un-optimized reference Minfo does
        or_wins = (d_rc > d_or) | ((d_rc == d_or) & (mc_rc < mc_or))
        use_or = jnp.where(keep_rc, or_wins & keep_or, keep_or)
        use_rc = keep_rc & jnp.logical_not(use_or)
        present_l = use_or | use_rc

        hist_f = jnp.where(use_or[:, None], h_or, h_rc)
        d_f = jnp.where(use_or, d_or, jnp.where(use_rc, d_rc, D_MAX))
        v_f = jnp.where(use_or, v_or, v_rc)
        mc_f = jnp.where(use_or, mc_or, mc_rc)
        uc_f = jnp.where(use_or, uc_or, uc_rc)

        # closest scan (ref: src/query.cpp:103-137): or entries first, then
        # rc entries, "<=" so later wins ties; we resolve residual ties by
        # higher slot (reference order is hash-map dependent)
        big = jnp.float64(D_MAX)

        def closest(keep, dm):
            cand, at = _f64_segment_min(dm, keep, seg, NB, lb)
            slot = jax.ops.segment_max(jnp.where(at, ls, -1), seg,
                                       num_segments=NB,
                                       indices_are_sorted=True)[:B]
            return cand[:B], slot

        cand_or, slot_or = closest(keep_or, d_or)
        has_or = slot_or >= 0
        best_d = jnp.where(has_or, cand_or, big)
        best_slot = jnp.where(has_or, slot_or, -1)
        cand_rc, slot_rc = closest(keep_rc, d_rc)
        rc_wins = (slot_rc >= 0) & (cand_rc <= best_d)
        best_d = jnp.where(rc_wins, cand_rc, best_d)
        best_slot = jnp.where(rc_wins, slot_rc, best_slot).astype(jnp.int32)
        best_strand = jnp.where(rc_wins, 1, 0).astype(jnp.int32)

        # override the resolved map at the closest slot with the closest
        # version (ref: src/query.cpp:136-138)
        is_best = lv & (best_slot[lb] >= 0) & (ls == best_slot[lb])
        rc_best = is_best & (best_strand[lb] == 1)
        or_best = is_best & (best_strand[lb] == 0)
        hist_f = jnp.where(rc_best[:, None], h_rc, hist_f)
        hist_f = jnp.where(or_best[:, None], h_or, hist_f)
        d_f = jnp.where(rc_best, d_rc, jnp.where(or_best, d_or, d_f))
        v_f = jnp.where(rc_best, v_rc, jnp.where(or_best, v_or, v_f))
        mc_f = jnp.where(rc_best, mc_rc, jnp.where(or_best, mc_or, mc_f))
        uc_f = jnp.where(rc_best, uc_rc, jnp.where(or_best, uc_or, uc_f))
        present_l = present_l | is_best

        # chi-square LRT of every leaf vs the closest (ref: src/query.cpp:420-424).
        # is_best marks exactly one lane per read, so these "sums" are
        # single-lane selects (exact; hist and uc in int32).
        def best_sum_i(x):
            return jax.ops.segment_sum(
                jnp.where(is_best, x, 0), seg, num_segments=NB,
                indices_are_sorted=True)[:B].astype(F)

        hist_c = jax.ops.segment_sum(
            jnp.where(is_best[:, None], hist_f, 0), seg,
            num_segments=NB, indices_are_sorted=True)[:B].astype(F)
        uc_c = best_sum_i((onm_l - mc_f).astype(jnp.int32))
        has_best = best_slot >= 0
        rho_c = jnp.where(has_best,
                          _f64_segment_select(rho_l, is_best, seg, NB)[:B],
                          0.0)
        v_c = jnp.where(has_best,
                        _f64_segment_select(v_f, is_best, seg, NB)[:B], 0.0)
        ratio_l = 2.0 * (self._llh(d_f, hist_c[lb], uc_c[lb], rho_c[lb])
                         - v_c[lb])

        return dict(idx=idx, lv=lv, lb=lb, ls=ls, lane_over=lane_over,
                    present_l=present_l, hist_f=hist_f, d_f=d_f, v_f=v_f,
                    mc_f=mc_f, uc_f=uc_f, rho_l=rho_l, best_slot=best_slot,
                    best_d=best_d, hist_c=hist_c, uc_c=uc_c, rho_c=rho_c,
                    v_c=v_c, ratio_l=ratio_l)

    def _event_lane_join(self, nb_lane, leaf_lane, hist_lanes, K: int,
                         B: int):
        """(strand-read, leaf) event lanes -> stage-2 lane inputs.

        Sorts event lanes by (read, leaf, strand), merges each or/rc pair
        into one (read, leaf) group, and compacts groups to K slots in
        ascending b*S+s order — exactly the lane set/order the dense
        extraction produces, with no [B, S] array materialised."""
        S = self.S
        CAP = nb_lane.shape[0]
        N = 2 * B
        BS = B * S
        K = min(K, CAP)
        valid = nb_lane < N
        strand = jnp.where(nb_lane >= B, 1, 0)
        b = nb_lane - strand * B
        big = BS << 1
        key = jnp.where(valid,
                        ((b * S + leaf_lane) << 1) | strand,
                        big).astype(jnp.int32)
        ks, perm = jax.lax.sort(
            (key, jnp.arange(CAP, dtype=jnp.int32)), num_keys=1)
        hist_s = hist_lanes[perm]
        vs = ks < big
        gkey = ks >> 1
        strand_s = ks & 1
        prev = jnp.concatenate([jnp.full((1,), -1, gkey.dtype), gkey[:-1]])
        first = (gkey != prev) & vs
        gid = jnp.maximum(jnp.cumsum(first.astype(jnp.int32)) - 1, 0)
        h_or_g = jax.ops.segment_sum(
            jnp.where((strand_s == 0) & vs, 1, 0)[:, None] * hist_s, gid,
            num_segments=CAP, indices_are_sorted=True)
        h_rc_g = jax.ops.segment_sum(
            jnp.where((strand_s == 1) & vs, 1, 0)[:, None] * hist_s, gid,
            num_segments=CAP, indices_are_sorted=True)
        gkey_g = jax.ops.segment_max(jnp.where(vs, gkey, -1), gid,
                                     num_segments=CAP,
                                     indices_are_sorted=True)
        ngroups = jnp.sum(first.astype(jnp.int32))
        pos = jnp.arange(K, dtype=jnp.int32)
        lv = pos < ngroups
        idx = jnp.where(lv, jnp.maximum(gkey_g[:K], 0), BS).astype(jnp.int32)
        h_or = jnp.where(lv[:, None], h_or_g[:K], 0)
        h_rc = jnp.where(lv[:, None], h_rc_g[:K], 0)
        lane_over = ngroups > K
        return idx, lv, h_or, h_rc, lane_over

    def _probe_and_lanes(self, tables, codes, lengths, leaf_ok,
                         lane_cap: Optional[int], exact: bool, tier: int):
        """Probe + lane extraction -> (L dict, onmers, probe_overflow).

        Single-device event mode stays in lane form end to end
        (event_probe_lanes + _event_lane_join); every other mode probes
        dense histograms and extracts lanes from them."""
        if getattr(self, "_event_lanes", False):
            from .event_probe import event_probe_lanes

            (slots_d, enc_se, row_start, row_ids, leaf_off, leaf_slots,
             heavy_tab) = tables
            rix2, res2, valid, onmers = self._strand_hashes(codes, lengths)
            urow, resident = self._urow(rix2, valid[None])
            sidx, hrow, resident = self._route_rows(row_ids, urow, resident)
            B, P = codes.shape[0], urow.shape[2]
            etier = max(tier, 2) if exact else tier
            E, KH, CAP_L = self._event_caps(B, P, etier)
            nb_lane, leaf_lane, hist_lanes, minall, ov = event_probe_lanes(
                slots_d, enc_se, row_start, leaf_off, leaf_slots,
                sidx, hrow, resident, res2, self.th, self.C0, self.S,
                self.di.max_bucket, E, KH, CAP_L, heavy_tab=heavy_tab,
                KR=self._resident_cap(2 * B * P))
            minall = minall.reshape(2, B)
            K = B * self.S if lane_cap is None else min(B * self.S,
                                                        lane_cap)
            idx, lv, h_or, h_rc, lane_over = self._event_lane_join(
                nb_lane, leaf_lane, hist_lanes, K, B)
            L = self._stage2_core(idx, lv, h_or, h_rc, minall[0], minall[1],
                                  onmers, leaf_ok, lane_over)
            return L, onmers, ov
        probe_out = self._probe_dispatch(tables, codes, lengths, exact,
                                         tier)
        onmers, ov = probe_out[4], probe_out[5]
        B = codes.shape[0]
        K = B * self.S if lane_cap is None else min(B * self.S, lane_cap)
        L = self._stage2_lanes(*probe_out[:5], leaf_ok, K)
        return L, onmers, ov

    def _stage2_impl(self, hist_or, hist_rc, minall_or, minall_rc, onmers,
                     leaf_ok, lane_cap: Optional[int] = None):
        """Dense [B, S] view of the lane-compacted stage 2 (scatter-back).

        lane_cap=None runs at full capacity (B*S lanes — cannot overflow;
        the exact fallback). Returns (the dense 14-tuple, lane_over)."""
        B = hist_or.shape[0]
        S = self.S
        BS = B * S
        K = BS if lane_cap is None else min(BS, lane_cap)
        L = self._stage2_lanes(hist_or, hist_rc, minall_or, minall_rc,
                               onmers, leaf_ok, K)
        return self._scatter_back(L, B, onmers), L["lane_over"]

    def _scatter_back(self, L, B: int, onmers):
        """Lane dict -> the dense 14-tuple (full out_mode)."""
        S = self.S
        BS = B * S
        X = self.th + 1
        idx = L["idx"]

        def scat(init, val):
            out = init.at[idx].set(val, mode="drop")
            return out.reshape((B, S) + val.shape[1:])

        present = scat(jnp.zeros((BS,), bool), L["present_l"])
        hist_f = scat(jnp.zeros((BS, X), jnp.int32), L["hist_f"])
        d_f = scat(jnp.full((BS,), D_MAX, F), L["d_f"])
        v_f = scat(jnp.zeros((BS,), F), L["v_f"])
        mc_f = scat(jnp.zeros((BS,), jnp.int32), L["mc_f"])
        uc_base = jnp.broadcast_to(onmers[:, None].astype(F),
                                   (B, S)).reshape(BS)
        uc_f = scat(uc_base, L["uc_f"])
        # absent lanes carry d = D_MAX, so their dense ratio is one
        # read-constant value (NaN through log(1 - D_MAX), as before)
        ratio_row = 2.0 * (self._llh(jnp.full((B,), D_MAX, F), L["hist_c"],
                                     L["uc_c"], L["rho_c"]) - L["v_c"])
        ratio = scat(jnp.repeat(ratio_row, S), L["ratio_l"])
        rho = jnp.broadcast_to(self._rho_slot[None, :], (B, S)).astype(F)
        return (present, hist_f, d_f, v_f, mc_f, uc_f, rho,
                L["best_slot"], L["best_d"], L["hist_c"], L["uc_c"],
                L["rho_c"], L["v_c"], ratio)

    def _probe_dispatch(self, tables, codes, lengths, exact: bool = False,
                        tier: int = 0):
        """Overridden by ShardedQueryEngine (resolved at trace time)."""
        return self._probe_impl(tables, codes, lengths, exact, tier)

    def _full_impl(self, tables, packed, vbits, lengths, leaf_ok,
                   exact: bool = False, out_mode: str = "full",
                   tier: int = 0, lane_exact: bool = False):
        """Fused probe + stage 2 (single dispatch) over 2-bit-packed reads.

        out_mode selects the OUTPUT SET, which defines what the program
        computes (XLA prunes dead values) and what is copied back to the
        host. "dist" returns a compacted tuple holding only what
        report_distances consumes; "dist_ratio" adds the closest-candidate
        summary for host-side chi-square recomputation; "full" returns the
        complete per-leaf state.
        """
        L = packed.shape[1] * 16
        codes = codec.unpack_codes(packed, lengths, L, vbits)
        B = codes.shape[0]
        S = self.S
        # _lane_cap_override: test hook forcing lane-cap truncation (real
        # worlds rarely exceed the 4096-lane floor)
        base_cap = getattr(self, "_lane_cap_override", None) or \
            max(8 * B, 4096)
        lane_cap = None if (exact or lane_exact) else min(
            B * S, base_cap << (2 * tier))
        lanes, onmers, probe_ov_raw = self._probe_and_lanes(
            tables, codes, lengths, leaf_ok, lane_cap, exact, tier)
        # overflow is a bit-flag word: bit 0 = probe capacity (heavy tail /
        # event caps), bit 1 = stage-2 lane cap — the two escalate
        # independently in fetch_prefetched
        probe_ov = jnp.max(jnp.asarray(probe_ov_raw).astype(jnp.int32))
        if out_mode in ("dist", "dist_ratio"):
            from ..core.compact import compact_mask_indices

            overflow = probe_ov | lanes["lane_over"].astype(jnp.int32) * 2
            present = jnp.zeros((B * S,), bool).at[lanes["idx"]].set(
                lanes["present_l"], mode="drop").reshape(B, S)
            bits = codec.pack_bits_device(present)
            # compact present-lane distances in index order: the first n
            # entries are exactly np.flatnonzero(present) — no index fetch
            # needed (host re-derives lanes from the bitmap). present lanes
            # are a subset of the (already ascending) stage-2 lane set.
            K = min(B * S, max(8 * B, 1024))
            pl = lanes["present_l"]
            pidx, nset = compact_mask_indices(pl, K)
            dval = lanes["d_f"][jnp.minimum(pidx, pl.shape[0] - 1)]
            fetch_over = nset > K
            base = (bits, dval, lanes["best_slot"].astype(jnp.int32))
            if out_mode == "dist_ratio":
                base = base + (lanes["hist_c"].astype(jnp.int32),
                               lanes["uc_c"].astype(jnp.int32),
                               lanes["v_c"])
            return base + (fetch_over, overflow)
        out = self._scatter_back(lanes, B, onmers)
        return tuple(out) + (
            onmers, probe_ov | lanes["lane_over"].astype(jnp.int32) * 2)

    # -------------------------------------------------------------- public
    def suggested_batch_reads(self, place: bool = False) -> int:
        """Reads per device batch keeping the dense per-(read, leaf) stage-2
        state (and stage-3 per-(read, tree-node) state for place) under
        ~1 GB of device memory. Many-genome indexes thus trade batch size for leaf
        count instead of overflowing; the event probe keeps the stage-1 cost
        independent of S either way. The lane-form event dist path never
        materialises [B, S] beyond a present bitmap, so its batches are
        bounded by lane capacities instead — bigger batches amortize the
        fixed per-dispatch overheads."""
        if getattr(self, "_event_lanes", False) and not place:
            per_read = 32 * max(self.S, 1)
            return min(32768, max(256, (1 << 30) // per_read))
        per_read = (256 if place else 128) * max(self.S, 1)
        return max(256, (1 << 30) // per_read)

    def _get_full_jit(self, out_mode: str, exact: bool = False,
                      tier: int = 0, lane_exact: bool = False):
        key = (out_mode, exact, tier, lane_exact)
        if key not in self._full_jits:
            self._full_jits[key] = jax.jit(functools.partial(
                self._full_impl, exact=exact, out_mode=out_mode, tier=tier,
                lane_exact=lane_exact))
        return self._full_jits[key]

    def prep_input(self, x):
        """Host array -> jit input (multi-host engines pass plain numpy so
        uncommitted inputs replicate over the global mesh)."""
        return jnp.asarray(x)

    def fetch_out(self, dev_out):
        """Device output tuple -> host numpy (multi-host: allgather)."""
        return jax.device_get(tuple(dev_out))

    def run_tier(self, codes, lengths, leaf_ok, tier: int,
                 out_mode: str = "full", lane_exact: bool = False):
        """Event-probe re-run at a larger capacity tier (overflow path).

        lane_exact=True removes the stage-2 lane cap entirely (the lane
        fallback when probe tiers fit but match lanes keep overflowing)."""
        if leaf_ok is None:
            leaf_ok = np.ones(self.S, bool)
        packed, vbits = codec.pack_codes_host(np.asarray(codes),
                                              np.asarray(lengths))
        return self._get_full_jit(out_mode, tier=tier,
                                  lane_exact=lane_exact)(
            self._tables, jnp.asarray(packed),
            None if vbits is None else jnp.asarray(vbits),
            jnp.asarray(lengths), jnp.asarray(leaf_ok))

    def run_leaf_stage_async(self, codes: np.ndarray, lengths: np.ndarray,
                             leaf_ok: Optional[np.ndarray] = None,
                             out_mode: str = "full"):
        """Dispatch the fused step; returns the device output tuple without
        blocking (for driver-level pipelining)."""
        if leaf_ok is None:
            leaf_ok = np.ones(self.S, bool)
        packed, vbits = codec.pack_codes_host(np.asarray(codes),
                                              np.asarray(lengths))
        return self._get_full_jit(out_mode)(
            self._tables, jnp.asarray(packed),
            None if vbits is None else jnp.asarray(vbits),
            jnp.asarray(lengths), jnp.asarray(leaf_ok))

    def fetch_leaf_stage(self, dev_out, lengths: np.ndarray,
                         codes: Optional[np.ndarray] = None,
                         leaf_ok: Optional[np.ndarray] = None,
                         out_mode: str = "full") -> "LeafResults":
        """One batched device_get of a run_leaf_stage_async result."""
        return self.fetch_prefetched(jax.device_get(tuple(dev_out)), lengths,
                                     codes=codes, leaf_ok=leaf_ok,
                                     out_mode=out_mode)

    def run_exact(self, codes, lengths, leaf_ok, out_mode: str = "full"):
        """Exact full-depth scan (heavy-tail overflow fallback)."""
        if leaf_ok is None:
            leaf_ok = np.ones(self.S, bool)
        packed, vbits = codec.pack_codes_host(np.asarray(codes),
                                              np.asarray(lengths))
        return self._get_full_jit(out_mode, exact=True)(
            self._tables, jnp.asarray(packed),
            None if vbits is None else jnp.asarray(vbits),
            jnp.asarray(lengths), jnp.asarray(leaf_ok))

    def fetch_prefetched(self, fetched, lengths: np.ndarray,
                         codes: Optional[np.ndarray] = None,
                         leaf_ok: Optional[np.ndarray] = None,
                         out_mode: str = "full") -> "LeafResults":
        """Build LeafResults from an already-device_get'ed output tuple."""
        ov_flags = int(np.max(np.asarray(fetched[-1])))
        over = ov_flags != 0
        fetch_over = (out_mode in ("dist", "dist_ratio")
                      and bool(np.asarray(fetched[-2])))
        if over or fetch_over:
            # bit 0: probe capacity (heavy tail / event caps) -> exact
            # full-depth rescan (event mode: capacity-tier escalation);
            # bit 1: stage-2 lane cap -> larger tiers, then uncapped lanes;
            # compact-fetch overflow (reads matching > K/B refs) -> full
            assert codes is not None, "overflow fallback needs the batch codes"
            if over and self.mode in ("event", "hybrid"):
                for tier in (1, 2, 3):
                    fetched = jax.device_get(tuple(self.run_tier(
                        codes, lengths, leaf_ok, tier)))
                    ov_flags = int(np.max(np.asarray(fetched[-1])))
                    if ov_flags == 0:
                        break
                else:
                    if ov_flags & 1:
                        if self.mode == "hybrid":
                            # probe capacity still exceeded at a 64x cap:
                            # exact full-depth CSR rescan, now a last resort
                            # instead of the only fallback
                            fetched = jax.device_get(tuple(self.run_exact(
                                codes, lengths, leaf_ok, out_mode="full")))
                        else:
                            raise RuntimeError(
                                "event-probe capacity tiers exhausted; the "
                                "batch is pathologically match-dense — "
                                "reduce the batch size")
                    else:
                        # probe caps fit, only match lanes overflow: the
                        # dense stage 2 (lane_cap=None) is always exact
                        fetched = jax.device_get(tuple(self.run_tier(
                            codes, lengths, leaf_ok, 3, lane_exact=True)))
                        if int(np.max(np.asarray(fetched[-1]))) & 1:
                            raise RuntimeError(
                                "event-probe capacity tiers exhausted; the "
                                "batch is pathologically match-dense — "
                                "reduce the batch size")
            else:
                run = self.run_exact if over else (
                    lambda c, l, ok, out_mode: self.run_leaf_stage_async(
                        c, l, ok, out_mode=out_mode))
                fetched = jax.device_get(tuple(run(
                    codes, lengths, leaf_ok, out_mode="full")))
            out_mode = "full"
        fetched = fetched[:-1]
        if out_mode in ("dist", "dist_ratio"):
            fetched = fetched[:-1]
            if out_mode == "dist_ratio":
                (bits, dval, best_slot, hist_c, uc_c, v_c) = fetched
            else:
                (bits, dval, best_slot) = fetched
                hist_c = uc_c = v_c = None
            B = bits.shape[0]
            S = self.S
            present = codec.unpack_bits_host(bits, S)
            d = np.full((B, S), D_MAX)
            lanes = np.flatnonzero(present.reshape(-1))
            d.reshape(-1)[lanes] = np.asarray(dval)[: len(lanes)]
            best_slot = np.asarray(best_slot)
            has_best = best_slot >= 0
            closest_d = np.where(
                has_best, d[np.arange(B), np.maximum(best_slot, 0)], D_MAX)
            rho_c = None
            if out_mode == "dist_ratio":
                rho_c = np.where(has_best,
                                 self.di.rho_slot[np.maximum(best_slot, 0)],
                                 0.0)
                hist_c = np.asarray(hist_c, np.float64)
                uc_c = np.asarray(uc_c, np.float64)
            return LeafResults(
                present=present, d=d, closest_slot=best_slot,
                closest_d=closest_d, hist_closest=hist_c, uc_closest=uc_c,
                rho_closest=rho_c, v_closest=v_c, onmers=None,
                lengths=np.asarray(lengths))
        (present, hist_f, d_f, v_f, mc_f, uc_f, rho, best_slot, best_d,
         hist_c, uc_c, rho_c, v_c, ratio) = fetched[:-1]
        onmers = fetched[-1]
        return LeafResults(
            present=present, hist=hist_f, d=d_f, v=v_f, match=mc_f, uc=uc_f,
            rho=np.asarray(rho), closest_slot=best_slot, closest_d=best_d,
            hist_closest=hist_c, uc_closest=uc_c, rho_closest=rho_c,
            v_closest=v_c, ratio=ratio, onmers=np.asarray(onmers),
            lengths=np.asarray(lengths))

    def compute_ratio_host(self, lr: "LeafResults") -> np.ndarray:
        """Chi-square LRT of every leaf vs the closest, on the host
        (ref: src/query.cpp:420-424). Identical accumulation order to the
        device path; used with out_mode='dist' fetches."""
        from ..core.llh import make_llh_np

        if not hasattr(self, "_llh_np"):
            self._llh_np = make_llh_np(self.lsh.k, self.lsh.h, self.th)
        return 2.0 * (self._llh_np(lr.d, lr.hist_closest[:, None, :],
                                   lr.uc_closest[:, None],
                                   lr.rho_closest[:, None])
                      - lr.v_closest[:, None])

    def run_leaf_stage(self, codes: np.ndarray, lengths: np.ndarray,
                       leaf_ok: Optional[np.ndarray] = None):
        """Full stage1+2. Returns a LeafResults bundle of numpy arrays.

        leaf_ok masks leaf slots absent from the placement tree (the probe
        decode skips them, ref: src/query.cpp:374-375).
        """
        return self.fetch_leaf_stage(
            self.run_leaf_stage_async(codes, lengths, leaf_ok), lengths,
            codes=codes, leaf_ok=leaf_ok)


@dataclass
class LeafResults:
    """Strand-resolved per-(read, leaf-slot) match state = node_to_minfo.

    Fields not in the fetched out_mode are None (dist mode omits hist, v,
    match, uc, rho and ratio; ratio is recomputed on host on demand)."""

    present: np.ndarray       # bool [B, S]
    d: np.ndarray             # f64 [B, S] (D_MAX where absent)
    closest_slot: np.ndarray  # int32 [B] (-1 if none)
    closest_d: np.ndarray     # f64 [B]
    hist_closest: np.ndarray  # f64 [B, th+1]
    uc_closest: np.ndarray    # f64 [B]
    rho_closest: np.ndarray   # f64 [B]
    v_closest: np.ndarray     # f64 [B]
    onmers: np.ndarray        # int32 [B]
    lengths: np.ndarray       # int32 [B]
    hist: Optional[np.ndarray] = None    # int32 [B, S, th+1]
    v: Optional[np.ndarray] = None       # f64 [B, S]
    match: Optional[np.ndarray] = None   # int32 [B, S]
    uc: Optional[np.ndarray] = None      # f64 [B, S]
    rho: Optional[np.ndarray] = None     # f64 [B, S]
    ratio: Optional[np.ndarray] = None   # f64 [B, S] chisq vs closest


class SeekEngine:
    """Single-target sketch search (ref: src/seek.cpp).

    Same probe layouts as QueryEngine: a [nrows_u, 1+C0] bucket-row table
    (word 0 = count, then C0 residuals) when buckets are shallow, else the
    CSR scan."""

    def __init__(self, sketch: DeviceSketch, hdist_th: int = 4):
        self.sk = sketch
        self.th = int(hdist_th)
        self.lsh = sketch.lsh
        self._res_resident = [bool(b) for b in sketch.resident]
        self._res_rank = [int(r) for r in sketch.res_rank]
        slots = self._build_direct_table(sketch)
        if slots is not None:
            self.mode = "direct"
            self.C0 = max(1, sketch.max_bucket)
            self._tables = (jnp.asarray(slots),)
        else:
            self.mode = "csr"
            row_start = sketch.row_start.astype(
                np.int32 if sketch.row_start[-1] < 2**31 else np.int64)
            row_ids = (None if sketch.row_ids is None
                       else sketch.row_ids.astype(np.int32))
            self._tables = (jnp.asarray(sketch.enc_v), jnp.asarray(row_start),
                            None if row_ids is None else jnp.asarray(row_ids))
        self._llh = make_llh(self.lsh.k, self.lsh.h, self.th)
        self._llh_fast = make_llh_fast(self.lsh.k, self.lsh.h, self.th)
        self._run_jit = jax.jit(self._run_impl)

    def _build_direct_table(self, sk: DeviceSketch):
        if sk.row_ids is not None or sk.max_bucket > SEEK_DIRECT_CAP:
            return None
        C0 = max(1, sk.max_bucket)
        if sk.nrows_u * (1 + C0) * 4 > DIRECT_MEM_CAP:
            return None
        counts = np.diff(sk.row_start)
        urow_of = np.repeat(np.arange(sk.nrows_u, dtype=np.int64), counts)
        j = (np.arange(len(sk.enc_v), dtype=np.int64)
             - np.repeat(sk.row_start[:-1], counts))
        slots = np.zeros((sk.nrows_u, 1 + C0), np.uint32)
        slots[:, 0] = counts.astype(np.uint32)
        slots[urow_of, 1 + j] = sk.enc_v
        return slots

    def _urow(self, rix, valid):
        m = self.lsh.m
        rmod = (rix % jnp.uint32(m)).astype(jnp.int32)
        resident = jnp.zeros(rmod.shape, bool)
        rank = jnp.zeros(rmod.shape, jnp.int32)
        for r in range(m):
            if self._res_resident[r]:
                hit = rmod == r
                resident = resident | hit
                if self._res_rank[r] > 0:
                    rank = jnp.where(hit, self._res_rank[r], rank)
        resident = resident & valid
        urow = (rix // jnp.uint32(m)).astype(jnp.int32) * self.sk.R + rank
        return jnp.where(resident, urow, 0), resident

    def _strand_min(self, tables, rix, res, valid):
        urow, resident = self._urow(rix, valid)
        if self.mode == "direct":
            (slots,) = tables
            ent = slots[urow]                       # [B, P, 1+C0]
            cnt = ent[..., 0].astype(jnp.int32)
            hd = codec.hdist_lr32(ent[..., 1:], res[..., None])
            j = jax.lax.broadcasted_iota(jnp.int32, hd.shape, hd.ndim - 1)
            match = resident[..., None] & (j < cnt[..., None]) & (hd <= self.th)
            gmin = jnp.min(jnp.where(match, hd, HD_SENTINEL), axis=-1)
            return jnp.where(gmin <= self.th, gmin, HD_SENTINEL)
        enc_v, row_start, row_ids = tables
        start, cnt = _csr_bucket_slices(row_start, row_ids, urow, resident)
        return scan_buckets_min(enc_v, start, cnt, res, self.th,
                                self.sk.max_bucket)

    def _run_impl(self, tables, packed, vbits, lengths):
        codes = codec.unpack_codes(packed, lengths, packed.shape[1] * 16,
                                   vbits)
        lsh = self.lsh
        k = lsh.k
        B, L = codes.shape
        P = L - k + 1
        th = self.th
        t_idx = jnp.arange(P, dtype=jnp.int32)
        rix_or, rix_rc, res_or, res_rc, valid_w = \
            codec.strand_hashes_conv(codes, lsh)
        valid = valid_w & (t_idx[None, :] <= lengths[:, None] - k)
        onmers = jnp.sum(valid, axis=1, dtype=jnp.int32)
        xs = jnp.arange(th + 1, dtype=jnp.int32)

        outs = []
        for rix, res in ((rix_or, res_or), (rix_rc, res_rc)):
            gmin = self._strand_min(tables, rix, res, valid)
            onehot = (gmin[..., None] == xs[None, None, :])
            hist = jnp.sum(onehot, axis=1).astype(F)          # [B, th+1]
            matchc = jnp.sum(hist, axis=-1)
            bx = jnp.einsum("bx,x->b", hist, xs.astype(F))
            uc = (onmers.astype(F) - matchc)
            rho = jnp.full((B,), self.sk.rho, F)

            def f(d, a=matchc, b=bx, uc=uc, rho=rho):
                return self._llh_fast(d, a, b, uc, rho)

            d, v = brent_find_minima(f, (B,))
            outs.append((matchc, d))
        (mc_or, d_or), (mc_rc, d_rc) = outs
        has = (mc_or + mc_rc) > 0
        d = jnp.where(d_or < d_rc, d_or, d_rc)
        return has, d

    def run(self, codes: np.ndarray, lengths: np.ndarray):
        packed, vbits = codec.pack_codes_host(np.asarray(codes),
                                              np.asarray(lengths))
        has, d = self._run_jit(self._tables, jnp.asarray(packed),
                               None if vbits is None else jnp.asarray(vbits),
                               jnp.asarray(lengths))
        return jax.device_get((has, d))
