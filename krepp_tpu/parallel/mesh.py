"""Multi-chip sharded querying: LSH-row-sharded index + data-parallel reads.

The reference is single-process OpenMP (ref: src/krepp.cpp:356-394); the
scale-out here shards the flat CSR by contiguous unified-row blocks
(balanced by ENTRY count, not row count) across the `shard` mesh axis — each
probe's bucket lives entirely on one shard, so per-shard first-match
histograms sum exactly — and shards read batches over the `data` axis.
Collectives: psum of histogram partials and pmin of the global min-distance
over `shard` — all under one jit. The mesh is a plain reshape of the
device list: the cards of one host are joined all to all, so no device
order is better than another.

Each shard carries the same hybrid bucket-row table + CSR heavy tail as the
single-device engine (including its probe epilogue), so multi-chip
inherits the fast probe rather than the scan-loop formulation. Sparse row
spaces (h >= 13 default indexes, ref: src/krepp.hpp:47-58) shard their
nonempty-row id table the same way and binary-search shard-locally.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index.index import DeviceIndex
from ..query.engine import (QueryEngine, DIRECT_MEM_CAP, DENSE_SLOTS,
                            build_hybrid_slots, hybrid_flavor)
from ..query.bucket_scan import probe_strand, probe_strand_full

INT32_SENTINEL = np.int32(2**31 - 1)


def make_query_mesh(n_data: int, n_shard: int, devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    assert devices.size >= n_data * n_shard
    return Mesh(devices[: n_data * n_shard].reshape(n_data, n_shard),
                ("data", "shard"))


class ShardedQueryEngine(QueryEngine):
    """QueryEngine whose stage-1 probe runs under shard_map on a mesh.

    Index rows are block-sharded over `shard` (blocks balanced by entry
    count); reads over `data`; stage 2 runs on the replicated (psum-merged)
    histograms.
    """

    def __init__(self, dindex: DeviceIndex, mesh: Mesh, hdist_th: int = 4):
        self.mesh = mesh
        self.n_shard = mesh.shape["shard"]
        self.n_data = mesh.shape["data"]
        super().__init__(dindex, hdist_th)

    def _put(self, x: np.ndarray, sharding):
        """Place a host array on the mesh (overridden for multi-host,
        where non-addressable shards must come from a callback)."""
        return jax.device_put(x, sharding)

    def _init_tables(self, dindex: DeviceIndex) -> None:
        """Shard-placed arrays replace the single-device tables."""
        import os

        # many-genome indexes keep the LANE form across shards: per-shard
        # event lanes all_gather over `shard` and join, so memory and
        # collective volume stay independent of S (the
        # dense [B, S, X] psum fallback remains behind KREPP_SHARD_DENSE)
        self._event_lanes = (self._use_event
                             and not os.environ.get("KREPP_SHARD_DENSE"))
        if self._use_event:
            # many-genome index: per-shard event probe over 'se'-flavor
            # bucket-row shards + a replicated leaf-slot CSR; per-shard
            # histogram partials psum exactly (a probe's bucket lives on
            # one shard, so per-(read, leaf, pos) dedupe is shard-local)
            self._build_shards(dindex, force_flavor="se")
            assert self.mode == "hybrid", \
                "event-mode shards need the bucket-row table"
            self.mode = "event"
            self._leafoff_dev = self._put(
                np.asarray(dindex.leaf_csr_off),
                NamedSharding(self.mesh, P(None)))
            self._leafslots_dev = self._put(
                np.asarray(dindex.leaf_csr_slots),
                NamedSharding(self.mesh, P(None)))
            self._mask_dev = None
            self._tables = ()
            return
        self.W = dindex.se_mask.shape[1]
        self._build_shards(dindex)
        self._mask_dev = self._put(
            np.asarray(dindex.se_mask),
            NamedSharding(self.mesh, P(None, None)))
        self._tables = ()

    def _build_shards(self, di: DeviceIndex,
                      force_flavor: Optional[str] = None) -> None:
        D = self.n_shard
        W = self.W
        self._dense_space = di.row_ids is None
        starts = di.row_start.astype(np.int64)
        ncontent = len(starts) - 1

        # contiguous content-row blocks balanced by entry count
        total = int(starts[-1])
        targets = (np.arange(1, D, dtype=np.int64) * total) // max(D, 1)
        cuts = np.searchsorted(starts, targets, side="left")
        bnd = np.concatenate([[0], cuts, [ncontent]]).astype(np.int64)
        bnd = np.maximum.accumulate(bnd)
        self._row_bounds = bnd

        # unified-row routing bounds per shard
        if self._dense_space:
            ulo = bnd.copy()
            ulo[-1] = di.nrows_u
        else:
            rid = di.row_ids
            ulo = np.zeros(D + 1, np.int64)
            for s in range(1, D):
                ulo[s] = rid[bnd[s]] if bnd[s] < ncontent else INT32_SENTINEL
            ulo[-1] = INT32_SENTINEL
        bounds = np.stack([ulo[:-1], ulo[1:]], axis=1).astype(np.int32)

        maxrows = max(1, int(np.max(bnd[1:] - bnd[:-1])))
        maxlen = max(1, int(np.max(starts[bnd[1:]] - starts[bnd[:-1]])))
        enc_se = np.zeros((D, maxlen, 2), np.uint32)
        row_sh = np.zeros((D, maxrows + 1), np.int32)
        rid_sh = np.full((D, maxrows), INT32_SENTINEL, np.int32)
        self.C0 = min(DENSE_SLOTS, max(1, di.max_bucket))
        flavor = force_flavor or hybrid_flavor(maxrows + 1, di.max_bucket,
                                               W, DIRECT_MEM_CAP)
        slot_blocks = []
        for s in range(D):
            lo, hi = int(bnd[s]), int(bnd[s + 1])
            b, e = int(starts[lo]), int(starts[hi])
            enc_se[s, : e - b, 0] = di.enc_v[b:e]
            enc_se[s, : e - b, 1] = di.se_v[b:e].astype(np.uint32)
            seg = starts[lo: hi + 1] - b
            row_sh[s, : hi - lo + 1] = seg
            row_sh[s, hi - lo + 1:] = seg[-1] if len(seg) else 0
            if not self._dense_space:
                rid_sh[s, : hi - lo] = di.row_ids[lo:hi]
            if flavor is not None:
                blk, _ = build_hybrid_slots(
                    starts[lo: hi + 1] - b, di.enc_v[b:e], di.se_v[b:e],
                    di.se_mask,
                    (hi - lo) if self._dense_space else None,
                    max(1, di.max_bucket), W, flavor=flavor)
                slot_blocks.append(blk)

        sh1 = NamedSharding(self.mesh, P("shard", None))
        sh2 = NamedSharding(self.mesh, P("shard", None, None))
        self._enc_se_dev = self._put(enc_se, sh2)
        self._rowstart_dev = self._put(row_sh, sh1)
        self._bounds_dev = self._put(bounds, sh1)
        self._rowids_dev = (None if self._dense_space
                            else self._put(rid_sh, sh1))
        if flavor is not None:
            self.mode = "hybrid"
            self.hflavor = flavor
            nsrows = maxrows if self._dense_space else maxrows + 1
            width = slot_blocks[0].shape[1]
            slots = np.zeros((D, nsrows, width), np.uint32)
            for s, blk in enumerate(slot_blocks):
                slots[s, : blk.shape[0]] = blk
            self._slots_dev = self._put(slots, sh2)
            self._zero_row = nsrows - 1  # all-zero on every shard
        else:
            self.mode = "csr"
            self._slots_dev = None

    # ------------------------------------------------------- sharded probe
    def _shard_route(self, urow, resident, bounds_s, rowids_s):
        """Shard-local routing: urow -> (mine, sidx, hrow).

        Dense row spaces translate urow to the local block offset; sparse
        ones binary-search this shard's row-id slice, with misses sent to
        the trailing all-zero slot row."""
        ulo = bounds_s[0]
        mine = resident & (urow >= ulo) & (urow < bounds_s[1])
        if self._dense_space:
            lrow = jnp.where(mine, urow - ulo, 0)
            return mine, lrow, lrow
        nnz = rowids_s.shape[0]
        pos = jnp.searchsorted(rowids_s, urow).astype(jnp.int32)
        posc = jnp.minimum(pos, nnz - 1)
        found = mine & (rowids_s[posc] == urow)
        sidx = jnp.where(found, posc, self._zero_row)
        return found, sidx, posc

    def _probe_dispatch(self, tables, codes, lengths, exact: bool = False,
                        tier: int = 0):
        del tables  # shard-placed arrays are used instead
        return self._sharded_probe(codes, lengths, exact, tier)

    def _sharded_probe(self, codes, lengths, exact: bool = False,
                       tier: int = 0):
        from ..query.event_probe import event_probe

        mesh = self.mesh
        event = self.mode == "event"
        if event and exact:
            tier = max(tier, 2)
        hybrid = self.mode == "hybrid" and not exact

        def step(codes_l, lengths_l, mask_t, enc_se_s, rowstart_s, bounds_s,
                 rowids_s, slots_s, leafoff_t, leafslots_t):
            B = codes_l.shape[0]
            rix2, res2, valid, onmers = self._strand_hashes(codes_l,
                                                            lengths_l)
            urow, resident = self._urow(rix2, valid[None])   # [2, B, P]
            mine, sidx, hrow = self._shard_route(
                urow, resident, bounds_s[0],
                None if rowids_s is None else rowids_s[0])
            if event:
                P_ = urow.shape[2]
                E, KH, CAP_L = self._event_caps(B, P_, tier)
                hist, minall, ov = event_probe(
                    slots_s[0], enc_se_s[0], rowstart_s[0], leafoff_t,
                    leafslots_t, sidx, hrow, mine, res2, self.th, self.C0,
                    self.S, self.di.max_bucket, E, KH, CAP_L)
                hist = hist.reshape(2, B, self.S, self.th + 1)
                minall = minall.reshape(2, B)
                hists, minalls = (hist[0], hist[1]), (minall[0], minall[1])
            elif hybrid:
                hist, minall, ov = self._hybrid_core(
                    slots_s[0], enc_se_s[0], rowstart_s[0], mask_t,
                    sidx, hrow, mine, res2, self.di.max_bucket, tier)
                hist = hist.reshape(2, B, self.S, self.th + 1)
                minall = minall.reshape(2, B)
                hists, minalls = (hist[0], hist[1]), (minall[0], minall[1])
            else:
                start = rowstart_s[0][hrow]
                cnt = jnp.where(mine, rowstart_s[0][hrow + 1] - start, 0)
                hists, minalls = [], []
                ov = jnp.bool_(False)
                for st in range(2):
                    if exact:
                        h, mn = probe_strand_full(
                            enc_se_s[0], mask_t, self._expand, start[st],
                            cnt[st], res2[st], self.th, self.W, self.S,
                            self.di.max_bucket)
                        o = jnp.bool_(False)
                    else:
                        h, mn, o = probe_strand(
                            enc_se_s[0], mask_t, self._expand, start[st],
                            cnt[st], res2[st], self.th, self.W, self.S,
                            self.di.max_bucket)
                    ov = ov | o
                    hists.append(h)
                    minalls.append(mn)
            # exact cross-shard merge: buckets are row-disjoint
            hist_or = jax.lax.psum(hists[0], "shard")
            hist_rc = jax.lax.psum(hists[1], "shard")
            minall_or = jax.lax.pmin(minalls[0], "shard")
            minall_rc = jax.lax.pmin(minalls[1], "shard")
            ov = jax.lax.pmax(ov.astype(jnp.int32), "shard") > 0
            ov_b = jnp.broadcast_to(ov, onmers.shape)
            return hist_or, hist_rc, minall_or, minall_rc, onmers, ov_b

        in_specs = [P("data", None), P("data"),
                    None if self._mask_dev is None else P(None, None),
                    P("shard", None, None), P("shard", None),
                    P("shard", None)]
        args = [codes, lengths, self._mask_dev, self._enc_se_dev,
                self._rowstart_dev, self._bounds_dev]
        if self._rowids_dev is not None:
            in_specs.append(P("shard", None))
            args.append(self._rowids_dev)
        else:
            in_specs.append(None)
            args.append(None)
        if self._slots_dev is not None:
            in_specs.append(P("shard", None, None))
            args.append(self._slots_dev)
        else:
            in_specs.append(None)
            args.append(None)
        if event:
            in_specs.extend([P(None), P(None)])
            args.extend([self._leafoff_dev, self._leafslots_dev])
        else:
            in_specs.extend([None, None])
            args.extend([None, None])

        fn = jax.shard_map(
            step, mesh=mesh, in_specs=tuple(in_specs),
            out_specs=(P("data"), P("data"), P("data"), P("data"), P("data"),
                       P("data")),
            check_vma=False)
        return fn(*args)

    # ---------------------------------------------- sharded event lanes
    def _probe_and_lanes(self, tables, codes, lengths, leaf_ok,
                         lane_cap, exact: bool, tier: int):
        """Event-mode lane pipeline under shard_map.

        Per-shard event lanes all_gather over `shard` and join + stage 2
        run replicated per data group INSIDE the step — no [B, S, X]
        histogram is ever materialised or psum'd, so memory and collective
        volume are independent of the genome count S. Hybrid/CSR modes
        keep the dense psum path (S is small there by construction)."""
        if not getattr(self, "_event_lanes", False):
            return super()._probe_and_lanes(tables, codes, lengths, leaf_ok,
                                            lane_cap, exact, tier)
        del tables
        B = codes.shape[0]                      # global batch
        S = self.S
        nd = self.n_data
        Bl = B // nd
        Kl = (Bl * S if lane_cap is None
              else min(Bl * S, max(lane_cap // nd, 4096)))
        out = self._sharded_event_lanes(codes, lengths, leaf_ok, exact,
                                        tier, Kl)
        (idx, lv, present_l, hist_f, d_f, v_f, mc_f, uc_f, rho_l,
         best_slot, best_d, hist_c, uc_c, rho_c, v_c, ratio_l,
         onmers, lane_over_b, ov_b) = out
        # owning read and leaf slot of each lane in the global read space,
        # as QueryEngine._stage2_core defines them (place reads both)
        lb = jnp.minimum(idx, B * S - 1) // S
        L = dict(idx=idx, lv=lv, lb=lb, ls=jnp.minimum(idx, B * S - 1)
                 - lb * S, present_l=present_l, hist_f=hist_f,
                 d_f=d_f, v_f=v_f, mc_f=mc_f, uc_f=uc_f, rho_l=rho_l,
                 best_slot=best_slot, best_d=best_d, hist_c=hist_c,
                 uc_c=uc_c, rho_c=rho_c, v_c=v_c, ratio_l=ratio_l,
                 lane_over=jnp.any(lane_over_b))
        return L, onmers, jnp.any(ov_b)

    def _sharded_event_lanes(self, codes, lengths, leaf_ok, exact: bool,
                             tier: int, Kl: int):
        from ..query.event_probe import event_probe_lanes

        mesh = self.mesh
        etier = max(tier, 2) if exact else tier
        S = self.S
        X = self.th + 1
        nd = self.n_data

        def step(codes_l, lengths_l, enc_se_s, rowstart_s, bounds_s,
                 rowids_s, slots_s, leafoff_t, leafslots_t, leaf_ok_t):
            Bl = codes_l.shape[0]
            rix2, res2, valid, onmers = self._strand_hashes(codes_l,
                                                            lengths_l)
            urow, resident = self._urow(rix2, valid[None])
            mine, sidx, hrow = self._shard_route(
                urow, resident, bounds_s[0],
                None if rowids_s is None else rowids_s[0])
            P_ = urow.shape[2]
            E, KH, CAP_L = self._event_caps(Bl, P_, etier)
            Np = 2 * Bl * P_
            # per-shard live lanes ~ resident/n_shard (entry-balanced row
            # blocks); a margin miss raises the overflow flag -> tier rerun
            KRs = min(Np, int(Np * self._res_frac() * 1.3
                              / max(self.n_shard, 1)) + 8192)
            nb_lane, leaf_lane, hist_lanes, minall, ov = event_probe_lanes(
                slots_s[0], enc_se_s[0], rowstart_s[0], leafoff_t,
                leafslots_t, sidx, hrow, mine, res2, self.th, self.C0,
                S, self.di.max_bucket, E, KH, CAP_L, heavy_tab=None,
                KR=KRs)
            # union of the shards' lanes: lane keys are batch-local and
            # shard-agnostic, so a shard-axis all_gather + join dedupes
            # exactly (each (read, pos) probe's bucket lives on ONE shard)
            nb_g = jax.lax.all_gather(nb_lane, "shard").reshape(-1)
            leaf_g = jax.lax.all_gather(leaf_lane, "shard").reshape(-1)
            hist_g = jax.lax.all_gather(hist_lanes, "shard").reshape(-1, X)
            minall = jax.lax.pmin(minall.reshape(2, Bl), "shard")
            ov = jax.lax.pmax(ov.astype(jnp.int32), "shard")
            idx, lv, h_or, h_rc, lane_over = self._event_lane_join(
                nb_g, leaf_g, hist_g, Kl, Bl)
            L = self._stage2_core(idx, lv, h_or, h_rc, minall[0],
                                  minall[1], onmers, leaf_ok_t, lane_over)
            # lane keys -> the global read space (group-blocked lanes stay
            # ascending: group g owns reads [g*Bl, (g+1)*Bl))
            off = jax.lax.axis_index("data").astype(jnp.int32) * (Bl * S)
            idx_g = jnp.where(L["lv"], L["idx"] + off,
                              jnp.int32(nd * Bl * S))
            lo_b = jnp.broadcast_to(L["lane_over"], (Bl,)).astype(jnp.int32)
            ov_b = jnp.broadcast_to(ov > 0, (Bl,)).astype(jnp.int32)
            return (idx_g, L["lv"], L["present_l"], L["hist_f"], L["d_f"],
                    L["v_f"], L["mc_f"], L["uc_f"], L["rho_l"],
                    L["best_slot"], L["best_d"], L["hist_c"], L["uc_c"],
                    L["rho_c"], L["v_c"], L["ratio_l"], onmers, lo_b, ov_b)

        in_specs = [P("data", None), P("data"),
                    P("shard", None, None), P("shard", None),
                    P("shard", None),
                    None if self._rowids_dev is None else P("shard", None),
                    P("shard", None, None), P(None), P(None), P(None)]
        out_specs = tuple([P("data")] * 19)
        fn = jax.shard_map(step, mesh=mesh, in_specs=tuple(in_specs),
                           out_specs=out_specs, check_vma=False)
        return fn(codes, lengths, self._enc_se_dev, self._rowstart_dev,
                  self._bounds_dev, self._rowids_dev, self._slots_dev,
                  self._leafoff_dev, self._leafslots_dev, leaf_ok)

    def run_leaf_stage(self, codes: np.ndarray, lengths: np.ndarray,
                       leaf_ok: Optional[np.ndarray] = None):
        # pad batch to a multiple of the data axis
        B = codes.shape[0]
        Bp = ((B + self.n_data - 1) // self.n_data) * self.n_data
        if Bp != B:
            codes = np.concatenate(
                [codes, np.full((Bp - B, codes.shape[1]), 4, codes.dtype)])
            lengths = np.concatenate([lengths, np.zeros(Bp - B, lengths.dtype)])
        out = super().run_leaf_stage(codes, lengths, leaf_ok)
        if Bp != B:
            import dataclasses

            out = dataclasses.replace(
                out, **{f.name: getattr(out, f.name)[:B]
                        for f in dataclasses.fields(out)
                        if getattr(out, f.name).shape[:1] == (Bp,)})
        return out
