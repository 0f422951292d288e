"""`place` driver: phylogenetic placement with jplace/tabular/summarize output.

Reproduces IBatch::place_sequences / report_placement semantics
(ref: src/query.cpp:198-333) with the ancestor walk turned into a dense
damping-weight matmul over the flattened placement tree and the per-edge ML
re-optimisation batched through the Brent solver.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, TextIO

import jax
import jax.numpy as jnp
import numpy as np

from ..core.codec import pad_codes_batch
from ..core.llh import brent_on_mask, F
from ..index.index import DeviceIndex, PlacementView
from ..io.fastx import QueryBatcher
from ..reports import (begin_jplace, end_jplace, fmt5, fmt5_array,
                       jplace_fields, jukes_cantor, place_header)
from .engine import QueryEngine, LeafResults, D_MAX
from .dist import _bucket_len, _pad_batch


# Stage-3 formulation threshold: dense damping-weight einsums while the
# [Qp, S] weight grid stays under this many cells (small trees: one matmul
# beats the event sort chain); larger worlds take the lane path whose cost
# is matches * depth, independent of S.
DENSE_AGG_MAX = 1 << 16


@dataclass
class PlaceConfig:
    hdist_th: int = 4
    chisq_value: float = 2.706
    tau: int = 2
    multi: bool = True
    no_filter: bool = False
    summarize: bool = False
    tabular: bool = False
    batch_bp: int = 16384 * 150
    # multi-host per-process output slicing: (rank, nranks); see DistConfig
    emit_slice: Optional[tuple] = None


def _support(wpos, present):
    """[B, Q+1] bool: some present leaf lies under each node. The 0/1 f32
    contraction counts at most S < 2^24 leaves, exact at HIGHEST precision
    (no TF32 rounding of the operands)."""
    return jnp.einsum("qs,bs->bq", wpos.astype(jnp.float32),
                      present.astype(jnp.float32),
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32) > 0


class PlaceAggregator:
    """Stage 3: leaf minfos -> per-placement-node stats (jitted).

    Two formulations share the candidate semantics
    (ref: src/query.cpp:218-296):

      * dense (`_agg_impl`, the `aggregate` API): damping-weight einsums
        over the full [B, Q+1, S] grid — exact but O(B*Q*S), kept for
        small trees and as the oracle for the lane path;
      * lanes (`_place_impl`, the production fused step): every present
        stage-2 (read, leaf) lane expands to its <= Dmax ancestor events,
        events sort by (read, qnode) and segment-reduce into compact
        node-lanes, and the Brent re-optimisation runs only on the
        compacted *candidate* lanes. Work scales with matches * depth,
        independent of S — the many-genome (S~10^3+) formulation.
    """

    def __init__(self, engine: QueryEngine, pv: PlacementView, cfg: PlaceConfig):
        self.engine = engine
        self.pv = pv
        self.cfg = cfg
        self.Q = pv.qflat.nnodes
        self._W = jnp.asarray(pv.weights)               # [Q+1, S]
        self._Wpos = jnp.asarray(pv.weights > 0)
        leaf_of_q = np.full(self.Q + 1, -1, np.int32)   # slot owning leaf node q
        for s, q in enumerate(pv.leaf_qse):
            if q > 0:
                leaf_of_q[q] = s
        self._leaf_of_q = jnp.asarray(leaf_of_q)
        self._is_leaf_q = jnp.asarray(leaf_of_q >= 0)
        self._rho_slot = engine._rho_slot
        self._llh = engine._llh
        self._llh_fast = engine._llh_fast
        # structural candidate gate: eff_nchildren-covered internal nodes
        # with a parent (ref: src/query.cpp:268-281)
        self._cand_struct = jnp.asarray(pv.candidate_ok
                                        & (pv.qflat.parent != 0))
        # per-slot ancestor chains for the lane path: post-order ids grow
        # root-ward, so np.flatnonzero yields leaf-first order (j=0 is the
        # slot's own qtree leaf node)
        S = engine.S
        W = pv.weights
        anc_lists = [np.flatnonzero(W[:, s] > 0) for s in range(S)]
        Dmax = max((len(a) for a in anc_lists), default=0)
        self._Dmax = max(Dmax, 1)
        anc_q = np.zeros((S, self._Dmax), np.int32)
        anc_w = np.zeros((S, self._Dmax), np.float64)
        for s, a in enumerate(anc_lists):
            anc_q[s, : len(a)] = a
            anc_w[s, : len(a)] = W[a, s]
        self._anc_q = jnp.asarray(anc_q)
        self._anc_w = jnp.asarray(anc_w)
        is_owner = np.zeros(S, bool)
        for s, q in enumerate(pv.leaf_qse):
            if q > 0 and leaf_of_q[q] == s:
                is_owner[s] = True
        self._is_owner = jnp.asarray(is_owner)
        self._rho_of_q = jnp.asarray(
            np.where(leaf_of_q >= 0,
                     np.asarray(engine.di.rho_slot)[np.maximum(leaf_of_q, 0)],
                     0.0))
        self._agg_jit = jax.jit(self._agg_impl)
        self._place_jits = {}
        # stage-3 formulation by scale (the lane path's sort chain costs
        # more than it saves on small trees): dense
        # damping-weight einsums when the [Qp, S] weight grid is small,
        # the ancestor-event lane path for many-genome worlds where
        # anything O(S) per read is the bound
        import os

        self._dense_agg = (self.Q + 1) * engine.S <= DENSE_AGG_MAX
        if os.environ.get("KREPP_PLACE_LANES"):
            self._dense_agg = False   # test hook: force the lane path

    def _agg_impl(self, present, hist, match, d, v, uc, onmers, lengths,
                  hist_c, uc_c, rho_c, v_c):
        """Returns per-(read, qnode): hist_q, uc_q, rho_q, d_q, v_q,
        support_q, leq_tau_q, chisq_q."""
        k = self.engine.lsh.k
        W = self._W
        p = present.astype(F)                                  # [B, S]
        histW = jnp.einsum("qs,bsx->bqx", W, hist.astype(F) * p[..., None])
        matchW = jnp.einsum("qs,bs->bq", W, match.astype(F) * p)
        support = _support(self._Wpos, present)
        rhoW = jnp.max(
            jnp.where(self._Wpos[None, :, :] & present[:, None, :],
                      self._rho_slot[None, None, :], 0.0), axis=2)
        enmers = (lengths - k + 1).astype(F)
        uc_int = enmers[:, None] - matchW                      # internal nodes

        # leaf nodes use their own strand-resolved minfo verbatim
        lq = jnp.maximum(self._leaf_of_q, 0)
        leaf_hist = hist[:, lq, :].astype(F)
        leaf_uc = uc[:, lq]
        leaf_d = d[:, lq]
        leaf_v = v[:, lq]
        leaf_rho = jnp.broadcast_to(self._rho_slot[lq][None, :], uc_int.shape)
        isl = self._is_leaf_q[None, :]
        hist_q = jnp.where(isl[..., None], leaf_hist, histW)
        uc_q = jnp.where(isl, leaf_uc, uc_int)
        rho_q = jnp.where(isl, leaf_rho, rhoW)

        # re-optimise internal candidates (ref: src/query.cpp:272-275);
        # only supported internal nodes need the solver
        need = support & jnp.logical_not(isl)
        xs = jnp.arange(hist_q.shape[-1], dtype=F)
        A_q = jnp.sum(hist_q, axis=-1)
        Bx_q = jnp.sum(hist_q * xs[None, None, :], axis=-1)
        d_opt, v_opt = brent_on_mask(self._llh_fast, A_q, Bx_q, uc_q, rho_q,
                                     need)
        d_q = jnp.where(isl, leaf_d, d_opt)
        v_q = jnp.where(isl, leaf_v, v_opt)

        tau = self.cfg.tau
        leq_tau = jnp.sum(hist_q[..., : tau + 1], axis=-1)
        chisq_q = 2.0 * (self._llh(d_q, hist_c[:, None, :], uc_c[:, None],
                                   rho_c[:, None]) - v_c[:, None])
        return hist_q, uc_q, rho_q, d_q, v_q, support, leq_tau, chisq_q

    def aggregate(self, lr: LeafResults):
        out = self._agg_jit(
            jnp.asarray(lr.present), jnp.asarray(lr.hist), jnp.asarray(lr.match),
            jnp.asarray(lr.d), jnp.asarray(lr.v), jnp.asarray(lr.uc),
            jnp.asarray(lr.onmers), jnp.asarray(lr.lengths),
            jnp.asarray(lr.hist_closest), jnp.asarray(lr.uc_closest),
            jnp.asarray(lr.rho_closest), jnp.asarray(lr.v_closest))
        return jax.device_get(tuple(out))

    def _place_dense(self, tables, packed, vbits, lengths, leaf_ok,
                     tier: int = 0):
        """Fused probe + stage 2 + DENSE placement aggregation for small
        [Qp, S] grids, returning the same device-compacted candidate tuple
        as the lane path.

        The ancestor walk (ref: src/query.cpp:248-265) is one damping-
        weight einsum over the weight grid; unlike the r03 formulation the
        Brent re-optimisation then runs only on the COMPACTED candidate
        lanes (support & structural & leq_tau & multi gates applied
        densely), so the f64 solver cost scales with candidates, not
        B * Qp."""
        from ..core.compact import compact_mask_indices

        eng = self.engine
        X = eng.th + 1
        tau = self.cfg.tau
        exact = tier > 0
        full = eng._full_impl(tables, packed, vbits, lengths, leaf_ok,
                              exact=exact, out_mode="full", tier=tier)
        (present, hist_f, d_f, v_f, mc_f, uc_f, _rho, best_slot, best_d,
         hist_c, uc_c, rho_c, v_c, _ratio) = full[:14]
        onmers, flags = full[14], full[15]
        overflow = jnp.asarray(flags).astype(jnp.int32) > 0
        B = present.shape[0]
        Qp = self.Q + 1
        n_pres = jnp.sum(present.astype(jnp.int32), axis=1)

        # ---- dense ancestor aggregation (the _agg_impl einsums)
        W = self._W
        p = present.astype(F)                                  # [B, S]
        histW = jnp.einsum("qs,bsx->bqx", W, hist_f.astype(F) * p[..., None])
        matchW = jnp.einsum("qs,bs->bq", W, mc_f.astype(F) * p)
        support = _support(self._Wpos, present)
        rhoW = jnp.max(
            jnp.where(self._Wpos[None, :, :] & present[:, None, :],
                      self._rho_slot[None, None, :], 0.0), axis=2)
        enmers = (lengths - eng.lsh.k + 1).astype(F)
        lq = jnp.maximum(self._leaf_of_q, 0)
        isl = self._is_leaf_q[None, :]                         # [1, Qp]
        own_p = present[:, lq] & isl                           # [B, Qp]
        hist_q = jnp.where(isl[..., None],
                           jnp.where(own_p[..., None],
                                     hist_f[:, lq, :].astype(F), 0.0),
                           histW)
        uc_q = jnp.where(isl,
                         jnp.where(own_p, uc_f[:, lq],
                                   onmers[:, None].astype(F)),
                         enmers[:, None] - matchW)
        rho_q = jnp.where(isl, self._rho_of_q[None, :], rhoW)
        leq_tau = jnp.sum(hist_q[..., : tau + 1], axis=-1)

        # ---- candidate gate + compaction (lane-path semantics)
        leq_tau_c = jnp.sum(hist_c[:, : tau + 1], axis=1)
        active = (n_pres > 0) & (self.cfg.no_filter | (leq_tau_c > 1.0))
        multi_r = active & (n_pres > 1)
        pre_cand = (support & self._cand_struct[None, :] & multi_r[:, None])
        if not self.cfg.no_filter:
            pre_cand = pre_cand & (leq_tau > 1.0)
        M = B * Qp
        Kc = min(M, max(4096, 8 * B) << (4 * tier))
        cidx, n_cand = compact_mask_indices(pre_cand.reshape(M), Kc)
        overflow = overflow | (n_cand > Kc)
        csafe = jnp.minimum(cidx, M - 1)
        cand_key = csafe                     # already b * Qp + q, ascending

        # ---- Brent only on compacted candidate lanes
        c_hist = hist_q.reshape(M, X)[csafe]
        A_c = jnp.sum(c_hist, axis=1)
        xs = jnp.arange(X, dtype=F)
        Bx_c = jnp.sum(c_hist * xs[None, :], axis=1)
        c_isl = self._is_leaf_q[csafe % Qp]
        d_opt, v_opt = brent_on_mask(
            self._llh_fast, A_c, Bx_c, uc_q.reshape(M)[csafe],
            rho_q.reshape(M)[csafe],
            jnp.logical_not(c_isl) & support.reshape(M)[csafe])
        o_has = own_p.reshape(M)[csafe]
        cand_d = jnp.where(c_isl,
                           jnp.where(o_has, d_f[:, lq].reshape(M)[csafe],
                                     D_MAX),
                           d_opt)
        cand_v = jnp.where(c_isl,
                           jnp.where(o_has, v_f[:, lq].reshape(M)[csafe],
                                     0.0),
                           v_opt)
        return (n_pres, best_slot, best_d, hist_c, uc_c, rho_c, v_c,
                cand_key, cand_d, cand_v, n_cand, onmers, overflow)

    def _place_impl(self, tables, packed, vbits, lengths, leaf_ok,
                    tier: int = 0):
        """Fused probe + stage 2 + LANE placement aggregation, returning a
        device-compacted candidate list.

        Work model (ref: src/query.cpp:218-296): each present (read, leaf)
        lane contributes its Minfo to every ancestor of the leaf in the
        placement tree with the damping weight (pp_map's denominators).
        Events (lane x ancestor) sort by (read, qnode) and segment-reduce
        into compact node-lanes; leaf node-lanes take the owning slot's
        strand-resolved minfo verbatim; the candidate gate — support &
        structural & leq_tau & multi-read activity — is applied per lane,
        candidates compact to Kc slots, and only those run the Brent
        re-optimisation. No [B, Q+1] or [B, Q+1, S] array is ever
        materialised, so cost is matches * tree-depth, independent of S.

        tier > 0 re-runs with 16x (tier 1) / 256x (tier 2) capacities and
        an exact full-depth probe; every cap carries an overflow flag."""
        from ..core import codec as _codec
        from ..core.compact import compact_mask_indices

        eng = self.engine
        X = eng.th + 1
        tau = self.cfg.tau
        codes = _codec.unpack_codes(packed, lengths, packed.shape[1] * 16,
                                    vbits)
        exact = tier > 0
        B = codes.shape[0]
        S = eng.S
        Qp = self.Q + 1
        K = min(B * S, max(8 * B, 4096) << (4 * tier))
        L, onmers, probe_ov = eng._probe_and_lanes(
            tables, codes, lengths, leaf_ok, K, exact, tier)
        overflow = jnp.max(jnp.asarray(probe_ov).astype(jnp.int32)) > 0
        overflow = overflow | L["lane_over"]
        lb, ls, lv, pl = L["lb"], L["ls"], L["lv"], L["present_l"]
        best_slot, best_d = L["best_slot"], L["best_d"]
        hist_c, uc_c, rho_c, v_c = (L["hist_c"], L["uc_c"], L["rho_c"],
                                    L["v_c"])
        seg_b = jnp.where(lv, lb, B)
        n_pres = jax.ops.segment_sum(pl.astype(jnp.int32), seg_b,
                                     num_segments=B + 1,
                                     indices_are_sorted=True)[:B]

        # ---- expand lanes to ancestor events (a sharded engine may return
        # more lanes than the cap asked for: its per-group caps have floors)
        Dm = self._Dmax
        M = lv.shape[0] * Dm
        q_e = self._anc_q[ls]                      # [K, Dm]
        own = self._is_owner[ls] & lv              # [K]
        valid = pl[:, None] & (q_e > 0)
        # the j=0 (own-leaf) event also rides for non-present owner lanes,
        # carrying the leaf override payload (weight-masked to 0 below)
        valid = valid.at[:, 0].set((pl | own) & (q_e[:, 0] > 0))
        big = B * Qp
        assert big < 2**31, "read-batch x tree too large for int32 keys"
        key_e = jnp.where(valid, lb[:, None] * Qp + q_e,
                          big).reshape(M).astype(jnp.int32)
        ks, ids = jax.lax.sort(
            (key_e, jnp.arange(M, dtype=jnp.int32)), num_keys=1)
        gvalid = ks < big
        prev = jnp.concatenate([jnp.full((1,), -1, ks.dtype), ks[:-1]])
        gfirst = (ks != prev) & gvalid
        gid = jnp.maximum(jnp.cumsum(gfirst.astype(jnp.int32)) - 1, 0)

        l_of = ids // Dm
        j_of = ids - l_of * Dm
        pl_e = pl[l_of] & gvalid
        w_ev = jnp.where(pl_e, self._anc_w[ls[l_of], j_of], 0.0)
        hist_l = L["hist_f"].astype(F)             # [K, X]
        mc_l = L["mc_f"].astype(F)
        rho_l = L["rho_l"]

        def gsum(x):
            return jax.ops.segment_sum(x, gid, num_segments=M,
                                       indices_are_sorted=True)

        histW = gsum(w_ev[:, None] * hist_l[l_of])          # [M, X]
        matchW = gsum(w_ev * mc_l[l_of])
        rhoM = jax.ops.segment_max(jnp.where(pl_e, rho_l[l_of], 0.0), gid,
                                   num_segments=M, indices_are_sorted=True)
        sup = gsum(pl_e.astype(jnp.int32)) > 0
        o_flag = own[l_of] & (j_of == 0) & gvalid
        o_has = gsum(o_flag.astype(jnp.int32)) > 0
        o_hist = gsum(jnp.where(o_flag[:, None], hist_l[l_of], 0.0))
        o_d = gsum(jnp.where(o_flag, L["d_f"][l_of], 0.0))
        o_v = gsum(jnp.where(o_flag, L["v_f"][l_of], 0.0))
        o_uc = gsum(jnp.where(o_flag, L["uc_f"][l_of], 0.0))
        gkey = jax.ops.segment_max(jnp.where(gvalid, ks, -1), gid,
                                   num_segments=M, indices_are_sorted=True)

        # ---- per node-lane values (dense _agg_impl semantics)
        gval = gkey >= 0
        gkey_c = jnp.maximum(gkey, 0)
        gb = gkey_c // Qp
        gq = gkey_c - gb * Qp
        isl = self._is_leaf_q[gq] & gval
        enmers = (lengths - eng.lsh.k + 1).astype(F)
        hist_q = jnp.where(isl[:, None],
                           jnp.where(o_has[:, None], o_hist, 0.0), histW)
        uc_q = jnp.where(isl,
                         jnp.where(o_has, o_uc, onmers[gb].astype(F)),
                         enmers[gb] - matchW)
        rho_q = jnp.where(isl, self._rho_of_q[gq], rhoM)
        leq_tau = jnp.sum(hist_q[:, : tau + 1], axis=1)

        # ---- candidate gate + compaction
        leq_tau_c = jnp.sum(hist_c[:, : tau + 1], axis=1)
        active = (n_pres > 0) & (self.cfg.no_filter | (leq_tau_c > 1.0))
        multi_r = active & (n_pres > 1)
        pre_cand = (gval & sup & self._cand_struct[gq] & multi_r[gb])
        if not self.cfg.no_filter:
            pre_cand = pre_cand & (leq_tau > 1.0)
        Kc = min(M, max(4096, 8 * B) << (4 * tier))
        cidx, n_cand = compact_mask_indices(pre_cand, Kc)
        overflow = overflow | (n_cand > Kc)
        csafe = jnp.minimum(cidx, M - 1)
        cand_key = gkey_c[csafe]

        # ---- Brent only on compacted candidate lanes
        c_hist = hist_q[csafe]
        A_c = jnp.sum(c_hist, axis=1)
        xs = jnp.arange(X, dtype=F)
        Bx_c = jnp.sum(c_hist * xs[None, :], axis=1)
        d_opt, v_opt = brent_on_mask(
            self._llh_fast, A_c, Bx_c, uc_q[csafe], rho_q[csafe],
            jnp.logical_not(isl[csafe]) & sup[csafe])
        c_isl = isl[csafe]
        cand_d = jnp.where(c_isl,
                           jnp.where(o_has[csafe], o_d[csafe], D_MAX),
                           d_opt)
        cand_v = jnp.where(c_isl,
                           jnp.where(o_has[csafe], o_v[csafe], 0.0),
                           v_opt)
        return (n_pres, best_slot, best_d, hist_c, uc_c, rho_c, v_c,
                cand_key, cand_d, cand_v, n_cand, onmers, overflow)

    def run_place_async(self, codes, lengths, leaf_ok, tier: int = 0):
        from ..core import codec as _codec

        eng = self.engine
        if tier not in self._place_jits:
            import functools

            impl = self._place_dense if self._dense_agg else self._place_impl
            self._place_jits[tier] = jax.jit(
                functools.partial(impl, tier=tier))
        packed, vbits = _codec.pack_codes_host(np.asarray(codes),
                                               np.asarray(lengths))
        return self._place_jits[tier](
            eng._tables, eng.prep_input(packed),
            None if vbits is None else eng.prep_input(vbits),
            eng.prep_input(lengths), eng.prep_input(leaf_ok))

    def run_place_exact(self, codes, lengths, leaf_ok, tier: int = 1):
        return self.run_place_async(codes, lengths, leaf_ok, tier=tier)

    def chisq_host(self, d_q, hist_c, uc_c, rho_c, v_c) -> np.ndarray:
        """chisq_q = 2 (llh(d_q | closest) - v_closest) on host f64."""
        self._ensure_llh_np()
        return 2.0 * (self._llh_np(d_q, hist_c[:, None, :], uc_c[:, None],
                                   rho_c[:, None]) - v_c[:, None])

    def chisq_cand_host(self, cb, cd, hist_c, uc_c, rho_c, v_c) -> np.ndarray:
        """Per-candidate-lane chi-square LRT vs the closest candidate
        (ref: src/query.cpp:284-296), host f64 over compacted lanes."""
        self._ensure_llh_np()
        return 2.0 * (self._llh_np(cd, hist_c[cb], uc_c[cb], rho_c[cb])
                      - v_c[cb])

    def _ensure_llh_np(self):
        from ..core.llh import make_llh_np

        if not hasattr(self, "_llh_np"):
            eng = self.engine
            self._llh_np = make_llh_np(eng.lsh.k, eng.lsh.h, eng.th)


def run_place(dindex: DeviceIndex, query_path: str, out: TextIO,
              invocation: str, cfg: Optional[PlaceConfig] = None,
              qtree=None, engine_factory=None) -> int:
    cfg = cfg or PlaceConfig()
    pv = dindex.placement_view(qtree)
    engine = engine_factory(dindex, cfg.hdist_th) if engine_factory else \
        QueryEngine(dindex, cfg.hdist_th)
    agg = PlaceAggregator(engine, pv, cfg)
    qflat = pv.qflat
    tree_nwk = pv.qtree.newick(jplace=True, fixed5=True)
    if cfg.summarize or cfg.tabular:
        out.write(place_header(invocation, tree_nwk, cfg.summarize, cfg.tabular))
    else:
        out.write(begin_jplace())

    leaf_ok = np.asarray(pv.leaf_qse > 0)
    names_q = qflat.names
    total = 0
    has_previous = False
    wcount = np.zeros(qflat.nnodes + 1)

    from collections import deque

    pending = deque()

    def flush_one():
        nonlocal has_previous
        names_b, lengths_b, codes_b, dev = pending.popleft()
        fetched = engine.fetch_out(dev)
        for tier in (1, 2):
            if not bool(np.any(fetched[-1])):
                break
            # heavy-tail / lane / candidate capacity overflow: escalate the
            # capacity tier (16x per tier) with the exact full-depth probe
            fetched = engine.fetch_out(agg.run_place_exact(
                codes_b, lengths_b, leaf_ok, tier=tier))
        else:
            if bool(np.any(fetched[-1])):
                raise RuntimeError("place capacity tiers exhausted; "
                                   "reduce the batch size")
        has_previous = flush_place_batch(
            agg, fetched, names_b, np.asarray(lengths_b), pv, cfg, out,
            wcount, has_previous)

    batch_bp = min(cfg.batch_bp,
                   engine.suggested_batch_reads(place=True) * 150)
    mult = getattr(engine, "n_data", 1)
    for names, seqs in QueryBatcher(query_path, bp_limit=batch_bp):
        total += len(names)
        codes, lengths = pad_codes_batch(
            seqs, pad_to=_bucket_len(max(len(s) for s in seqs)))
        codes, lengths = _pad_batch(codes, lengths, mult)
        dev = agg.run_place_async(codes, lengths, leaf_ok)
        pending.append((names, lengths, codes, dev))
        if len(pending) >= 3:
            flush_one()
    while pending:
        flush_one()
    if cfg.summarize:
        twcount = wcount.sum()
        for q in np.flatnonzero(wcount):
            w = wcount[q]
            nm = names_q[q] if names_q[q] else "NA"
            out.write(f"{nm}\t{q - 1}\t{fmt5(w)}\t{fmt5(w / twcount)}\n")
    elif not cfg.tabular:
        out.write(end_jplace(invocation, total, tree_nwk))
    return total


def flush_place_batch(agg: PlaceAggregator, fetched, names_b, lengths_b,
                      pv: PlacementView, cfg: PlaceConfig, out: TextIO,
                      wcount: np.ndarray, has_previous: bool) -> bool:
    """Host half of one fused place batch: unpack the device tuple,
    chi-square the compacted candidate lanes, emit the report."""
    (n_pres, best_slot, best_d, hist_c, uc_c, rho_c, v_c,
     cand_key, cand_d, cand_v, n_cand, onmers, _ov) = fetched
    m = min(int(n_cand), len(cand_key))
    Qp = agg.Q + 1
    idx = np.asarray(cand_key[:m], np.int64)
    cb = idx // Qp
    cq = idx % Qp
    cd = np.asarray(cand_d[:m])
    cv = np.asarray(cand_v[:m])
    chisq_c = agg.chisq_cand_host(cb, cd, hist_c, uc_c, rho_c, v_c)
    n_pres = np.asarray(n_pres)
    Breal = len(names_b)
    if len(n_pres) != Breal:                  # drop mesh padding reads
        keep = cb < Breal
        cb, cq, cd, cv, chisq_c = (cb[keep], cq[keep], cd[keep], cv[keep],
                                   chisq_c[keep])
        n_pres = n_pres[:Breal]
        best_slot, best_d = best_slot[:Breal], best_d[:Breal]
        hist_c, uc_c, rho_c, v_c = (hist_c[:Breal], uc_c[:Breal],
                                    rho_c[:Breal], v_c[:Breal])
        onmers, lengths_b = np.asarray(onmers)[:Breal], lengths_b[:Breal]
    if cfg.emit_slice:
        rank, nranks = cfg.emit_slice
        B = len(n_pres)
        lo, hi = rank * B // nranks, (rank + 1) * B // nranks
        keep = (cb >= lo) & (cb < hi)
        cb, cq, cd, cv, chisq_c = (cb[keep] - lo, cq[keep], cd[keep],
                                   cv[keep], chisq_c[keep])
        n_pres = n_pres[lo:hi]
        best_slot, best_d = best_slot[lo:hi], best_d[lo:hi]
        hist_c, uc_c, rho_c, v_c = (hist_c[lo:hi], uc_c[lo:hi],
                                    rho_c[lo:hi], v_c[lo:hi])
        onmers, lengths_b = np.asarray(onmers)[lo:hi], lengths_b[lo:hi]
        names_b = names_b[lo:hi]
    lr = LeafResults(
        present=None, d=None, closest_slot=best_slot,
        closest_d=best_d, hist_closest=hist_c, uc_closest=uc_c,
        rho_closest=rho_c, v_closest=v_c, onmers=np.asarray(onmers),
        lengths=lengths_b)
    return _report_batch(lr, n_pres, names_b, pv, cfg, out,
                         wcount, has_previous, cb, cq, cd, cv, chisq_c)


def _jplace_row(qflat, q: int, d: float, v: float, lwr: float) -> str:
    pend = qflat.blen[q] / 2.0 if not math.isnan(qflat.blen[q]) else 0.0
    return jplace_fields(q - 1, jukes_cantor(d) - pend, pend, -v, lwr, d)


def _jplace_rows_bulk(qflat, qs: np.ndarray, d: np.ndarray, v: np.ndarray,
                      lwr: np.ndarray) -> np.ndarray:
    """Vectorized _jplace_row over candidate arrays -> object str array."""
    blen = qflat.blen[qs]
    pend = np.where(np.isnan(blen), 0.0, blen / 2.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        jc = -0.75 * np.log(1.0 - (4.0 / 3.0) * d)
    en = (qs - 1).astype(str).astype(object)
    return ("[" + en + ", " + fmt5_array(jc - pend) + ", " + fmt5_array(pend)
            + ", " + fmt5_array(-v) + ", " + fmt5_array(lwr) + ", "
            + fmt5_array(d) + "]")


def _report_batch(lr: LeafResults, n_pres: np.ndarray, names: List[str],
                  pv: PlacementView, cfg: PlaceConfig, out: TextIO,
                  wcount: np.ndarray, has_previous: bool,
                  cb, cq, cd, cv, chisq_c) -> bool:
    """Bulk-vectorized report pass (ref: src/query.cpp:218-333).

    cb/cq/cd/cv/chisq_c are the device-compacted pre-chisq candidate lanes
    in row-major (read, qnode) order (mask semantics live in
    PlaceAggregator._place_impl); this pass applies the chi-square LRT
    filter, normalises LWRs and emits rows — all batch-wide, with only the
    jplace per-read nesting walking (emitted) reads."""
    qflat = pv.qflat
    B = len(n_pres)
    tau = cfg.tau
    names_a = np.asarray(names, dtype=object)

    leq_tau_c = lr.hist_closest[:, : tau + 1].sum(axis=1)
    active = (n_pres > 0) & (cfg.no_filter | (leq_tau_c > 1.0))
    single = active & (n_pres == 1)

    # single-match reads place on the closest leaf's edge with LWR 1
    sb = np.flatnonzero(single)
    s_q = pv.leaf_qse[lr.closest_slot[sb]].astype(np.int64)
    s_d = lr.closest_d[sb]
    s_v = lr.v_closest[sb]

    # chi-square LRT filter over the compacted candidates
    # (ref: src/query.cpp:284-296)
    keep = chisq_c < cfg.chisq_value
    cb, cq, cd, cv = cb[keep], cq[keep], cd[keep], cv[keep]
    lwr = np.exp(-chisq_c[keep] / 2.0)
    tot = np.bincount(cb, weights=lwr, minlength=B)
    counts = np.bincount(cb, minlength=B)
    with np.errstate(invalid="ignore", divide="ignore"):
        cw = lwr / tot[cb]

    if not cfg.multi and len(cb):
        # best by highest card, then lowest distance, then highest edge id
        # — the last element of the reference's stable (card, -d) sort
        # (ref: src/query.cpp:312-319)
        order = np.lexsort((-cq, cd, -qflat.card[cq], cb))
        _, first = np.unique(cb[order], return_index=True)
        pick = order[first]
        cb, cq, cd, cv, cw = cb[pick], cq[pick], cd[pick], cv[pick], cw[pick]
        counts = np.minimum(counts, 1)

    if cfg.summarize:
        np.add.at(wcount, s_q, 1.0)
        if cfg.multi:
            with np.errstate(divide="ignore"):
                np.add.at(wcount, cq, 1.0 / counts[cb])
        else:
            np.add.at(wcount, cq, 1.0)
        return has_previous

    if cfg.tabular:
        qn = np.asarray([x if x else "NA" for x in qflat.names], object)
        srows = (names_a[sb] + "\t" + qn[s_q] + "\t"
                 + (s_q - 1).astype(str).astype(object) + "\t1.00000\t"
                 + fmt5_array(s_d) + "\n")
        crows = (names_a[cb] + "\t" + qn[cq] + "\t"
                 + (cq - 1).astype(str).astype(object) + "\t"
                 + fmt5_array(cw) + "\t" + fmt5_array(cd) + "\n")
        order = np.argsort(np.concatenate([sb, cb]), kind="stable")
        out.write("".join(np.concatenate([srows, crows])[order].tolist()))
        return has_previous

    # jplace: the C bulk emitter renders the whole batch fragment (the
    # Python object-string assembly below costs ~10 us/read and dominated
    # the pipelined place driver's host side)
    starts = np.searchsorted(cb, np.arange(B))
    ends = np.searchsorted(cb, np.arange(B) + 1)
    s_of = np.full(B, -1, np.int64)
    s_of[sb] = np.arange(len(sb))
    from ..io import native_report

    kind = np.zeros(B, np.uint8)
    kind[active & single] = 1
    if cfg.multi:
        kind[active & ~single] = 2
    else:
        kind[active & ~single & (ends > starts)] = 2
    res = native_report.jplace_emit(
        names, kind, s_of, starts, ends, s_q, lr.closest_d[sb],
        lr.v_closest[sb], cq, cd, cv, cw, qflat.blen, cfg.multi,
        has_previous)
    if res is not None:
        frag, emitted = res
        out.write(frag)
        return has_previous or emitted > 0

    srows = _jplace_rows_bulk(qflat, s_q, s_d, s_v, np.ones(len(sb)))
    crows = _jplace_rows_bulk(qflat, cq, cd, cv, cw)
    parts: List[str] = []
    for b in np.flatnonzero(active):
        if single[b]:
            body = srows[s_of[b]] + "]}"
        elif cfg.multi:
            body = (",".join("\n\t\t\t\t" + r
                             for r in crows[starts[b]: ends[b]])
                    + "]\n\t\t\t}")
        elif ends[b] > starts[b]:
            body = crows[starts[b]] + "]}"
        else:
            continue
        if has_previous:
            parts.append(",\n")
        parts.append(f'\t\t\t{{"n" : ["{names[b]}"], "p" : [' + body)
        has_previous = True
    out.write("".join(parts))
    return has_previous
