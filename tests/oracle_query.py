"""Full-pipeline oracle: reference-semantics index build + dist + place in
pure Python (slow, exact). Used to validate the device pipeline end-to-end.

Mirrors: build_for_subtree + DynHT (ref: src/krepp.cpp:248-303,
src/table.cpp), IBatch::search_mers/add_matching_mer/summarize_matches
(ref: src/query.cpp:40-139,352-390), report_distances (ref: :158-196) and
report_placement (ref: :218-333).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import oracle

DBL_MAX = 1.7976931348623157e308


class OracleIndex:
    def __init__(self, k, w, ppos, npos, m, r, frac, tree):
        self.k, self.w = k, w
        self.ppos, self.npos = ppos, npos
        self.m, self.r, self.frac = m, r, frac
        self.tree = tree  # krepp_tpu Tree
        self.h = len(ppos)
        # local row -> enc -> set(leaf se)
        self.table: Dict[int, Dict[int, set]] = defaultdict(dict)
        self.rho: Dict[int, float] = {}

    def add_genome(self, leaf_se: int, contigs: List[str], rho: float = 1.0):
        seen = set()
        for seq in contigs:
            if len(seq) < self.w:
                continue
            kept, _, _ = oracle.extract_mers_oracle(
                seq, self.k, self.w, self.ppos, self.npos, self.m, self.r, self.frac)
            seen.update(kept)
        for row, enc in seen:
            self.table[row].setdefault(enc, set()).add(leaf_se)
        self.rho[leaf_se] = rho

    def apply_rho_partial(self):
        coef = ((self.r + 1) if self.frac else 1) / self.m
        for se in self.rho:
            self.rho[se] *= coef

    def resident(self, rix):
        rr = rix % self.m
        return rr <= self.r if self.frac else rr == self.r

    def bucket(self, rix):
        rr = rix % self.m
        local = rix // self.m * (self.r + 1) + rr if self.frac else rix // self.m
        return self.table.get(local, {})


class OMinfo:
    def __init__(self, th, nmers=0.0, rho=0.0):
        self.nmers = float(nmers)
        self.mismatch = float(nmers)
        self.match = 0.0
        self.rho = rho
        self.hist = [0.0] * (th + 1)
        self.pos_min: Dict[int, int] = {}
        self.hdist_min = 0xFFFFFFFF
        self.d = DBL_MAX
        self.v = float("nan")
        self.chisq = float("nan")
        self.lwr = 1.0

    def update(self, pos, hd):
        if pos not in self.pos_min:
            self.match += 1
            self.mismatch -= 1
            self.hist[hd] += 1
            self.pos_min[pos] = hd
        elif self.pos_min[pos] > hd:
            self.hist[hd] += 1
            self.hist[self.pos_min[pos]] -= 1
            self.pos_min[pos] = hd
        if hd < self.hdist_min:
            self.hdist_min = hd

    def add(self, other: "OMinfo", denom: float):
        if not self.nmers:
            self.mismatch = other.nmers
        self.match += other.match * denom
        self.mismatch -= other.match * denom
        for x in range(len(self.hist)):
            self.hist[x] += other.hist[x] * denom
        self.hdist_min = min(self.hdist_min, other.hdist_min)
        self.nmers = max(self.nmers, other.nmers)
        self.rho = max(self.rho, other.rho)

    def leq_tau(self, tau):
        return sum(self.hist[: tau + 1])

    def optimize(self, k, h, th):
        f = lambda d: oracle.llh_oracle(d, self.hist, self.mismatch, self.rho, k, h, th)
        self.d, self.v = oracle.brent_oracle(f, 1e-10, 0.5)

    def ratio_at(self, d, k, h, th):
        return 2 * (oracle.llh_oracle(d, self.hist, self.mismatch, self.rho,
                                      k, h, th) - self.v)


def query_read(oi: OracleIndex, seq: str, hdist_th: int):
    """search_mers + summarize_matches. Returns (node_to_minfo keyed by leaf
    se, closest_se, closest_minfo, onmers)."""
    k, h = oi.k, oi.h
    mers = oracle.search_mers_oracle(seq, k, oi.ppos, oi.npos)
    onmers = len(mers)
    leaf_or: Dict[int, OMinfo] = {}
    leaf_rc: Dict[int, OMinfo] = {}
    filt = [0xFFFFFFFF, 0xFFFFFFFF]
    enmers = len(seq) - k + 1
    for (opos, orix, ores, rpos, rrix, rres) in mers:
        for si, (pos, rix, res, lm) in enumerate(
                ((opos, orix, ores, leaf_or), (rpos, rrix, rres, leaf_rc))):
            if not oi.resident(rix):
                continue
            for enc, leaves in oi.bucket(rix).items():
                hd = oracle.hdist_lr32(enc, res)
                if hd > hdist_th:
                    continue
                if hd < filt[si]:
                    filt[si] = hd
                for se in leaves:
                    if se not in lm:
                        lm[se] = OMinfo(hdist_th, enmers, oi.rho[se])
                    lm[se].update(pos, hd)
    # summarize_matches (ref: src/query.cpp:96-139)
    filt = [(2 * f + 1) & 0xFFFFFFFF for f in filt]
    node_to_minfo: Dict[int, OMinfo] = {}
    closest = OMinfo(hdist_th)
    closest_se = None
    for se in sorted(leaf_or):
        mi = leaf_or[se]
        mi.mismatch = onmers - mi.match
        if mi.hdist_min > filt[0]:
            continue
        mi.optimize(k, h, hdist_th)
        if mi.d <= closest.d:
            closest, closest_se = mi, se
        node_to_minfo[se] = mi
    for se in sorted(leaf_rc):
        mi = leaf_rc[se]
        mi.mismatch = onmers - mi.match
        if mi.hdist_min > filt[1]:
            continue
        mi.optimize(k, h, hdist_th)
        if mi.d <= closest.d:
            closest, closest_se = mi, se
        node_to_minfo[se] = mi
        if se in leaf_or:
            mo = leaf_or[se]
            if (mi.d > mo.d) or (mi.d == mo.d and mi.match < mo.match):
                node_to_minfo[se] = mo
    if closest_se is not None:
        node_to_minfo[closest_se] = closest
    return node_to_minfo, closest_se, closest, onmers


def dist_rows(oi: OracleIndex, seq: str, hdist_th=4, chisq_value=2.706,
              dist_max=float("nan"), multi=True, no_filter=True):
    """report_distances (ref: src/query.cpp:158-196) -> list of (se, d) or
    None marker for the NA row."""
    k, h = oi.k, oi.h
    node_to_minfo, closest_se, closest, _ = query_read(oi, seq, hdist_th)
    no_dmax = math.isnan(dist_max)
    if not node_to_minfo or (not no_dmax and closest.d > dist_max):
        return None
    rows = []
    if multi:
        for se in sorted(node_to_minfo):
            mi = node_to_minfo[se]
            if not no_filter:
                if not (closest.ratio_at(mi.d, k, h, hdist_th) < chisq_value):
                    continue
            if no_dmax or mi.d < dist_max:
                rows.append((se, mi.d))
    else:
        rows.append((closest_se, closest.d))
    return rows


def place_read(oi: OracleIndex, seq: str, qtree_nodes, hdist_th=4,
               chisq_value=2.706, tau=2, no_filter=False, multi=True):
    """report_placement (ref: src/query.cpp:218-333) on the index tree.

    qtree_nodes: se -> Node of the placement tree (identity for index tree).
    Returns None (skip) or list of (qse, lwr, d, v) candidate placements
    (all candidates if multi else the selected one).
    """
    k, h = oi.k, oi.h
    node_to_minfo, closest_se, closest, onmers = query_read(oi, seq, hdist_th)
    if not node_to_minfo or not (no_filter or closest.leq_tau(tau) > 1.0):
        return None
    if len(node_to_minfo) == 1:
        nd = qtree_nodes[closest_se]
        return [(nd.se, 1.0, closest.d, closest.v)]
    pp: Dict[int, OMinfo] = {}
    nodes = {}
    for se, mi in node_to_minfo.items():
        nd = qtree_nodes[se]
        pp[nd.se] = mi
        nodes[nd.se] = nd
        denom = 1.0
        p = nd.parent
        cur_leaf = nd
        while p is not None:
            if p.is_taxon and cur_leaf.is_taxon:
                denom = 1.0
            else:
                denom /= p.eff_nchildren
            if p.se not in pp:
                pp[p.se] = OMinfo(hdist_th)
            pp[p.se].add(mi, denom)
            nodes[p.se] = p
            p = p.parent
    cands = []
    for qse in sorted(pp):
        nd = nodes[qse]
        mi = pp[qse]
        if nd.nchildren != nd.eff_nchildren or nd.nchildren == 1:
            continue
        if no_filter or mi.leq_tau(tau) > 1.0:
            if not nd.is_leaf:
                mi.optimize(k, h, hdist_th)
            mi.chisq = closest.ratio_at(mi.d, k, h, hdist_th)
            if mi.chisq < chisq_value and nd.parent is not None:
                cands.append(qse)
    total = 0.0
    for qse in cands:
        pp[qse].lwr = math.exp(-pp[qse].chisq / 2)
        total += pp[qse].lwr
    if multi:
        return [(qse, pp[qse].lwr / total, pp[qse].d, pp[qse].v) for qse in cands]
    best = sorted(cands, key=lambda q: (nodes[q].card, -pp[q].d))[-1]
    return [(best, pp[best].lwr / total, pp[best].d, pp[best].v)]


def query_read_mapped(oi: OracleIndex, seq: str, hdist_th: int, qtree_nodes):
    """query_read but decode skips index leaves absent from qtree_nodes
    (ref: src/query.cpp:374-375 null node skip)."""
    k, h = oi.k, oi.h
    mers = oracle.search_mers_oracle(seq, k, oi.ppos, oi.npos)
    onmers = len(mers)
    leaf_or: Dict[int, OMinfo] = {}
    leaf_rc: Dict[int, OMinfo] = {}
    filt = [0xFFFFFFFF, 0xFFFFFFFF]
    enmers = len(seq) - k + 1
    for (opos, orix, ores, rpos, rrix, rres) in mers:
        for si, (pos, rix, res, lm) in enumerate(
                ((opos, orix, ores, leaf_or), (rpos, rrix, rres, leaf_rc))):
            if not oi.resident(rix):
                continue
            for enc, leaves in oi.bucket(rix).items():
                hd = oracle.hdist_lr32(enc, res)
                if hd > hdist_th:
                    continue
                if hd < filt[si]:
                    filt[si] = hd
                for se in leaves:
                    if se not in qtree_nodes:
                        continue
                    if se not in lm:
                        lm[se] = OMinfo(hdist_th, enmers, oi.rho[se])
                    lm[se].update(pos, hd)
    filt = [(2 * f + 1) & 0xFFFFFFFF for f in filt]
    node_to_minfo: Dict[int, OMinfo] = {}
    closest = OMinfo(hdist_th)
    closest_se = None
    for lm, fi in ((leaf_or, filt[0]), (leaf_rc, filt[1])):
        for se in sorted(lm):
            mi = lm[se]
            mi.mismatch = onmers - mi.match
            if mi.hdist_min > fi:
                continue
            mi.optimize(k, h, hdist_th)
            if mi.d <= closest.d:
                closest, closest_se = mi, se
            if lm is leaf_rc and se in node_to_minfo:
                mo = node_to_minfo[se]
                if (mi.d > mo.d) or (mi.d == mo.d and mi.match < mo.match):
                    node_to_minfo[se] = mo
                    continue
            node_to_minfo[se] = mi
    if closest_se is not None:
        node_to_minfo[closest_se] = closest
    return node_to_minfo, closest_se, closest, onmers


def place_read_mapped(oi, seq, qtree_nodes, hdist_th=4, chisq_value=2.706,
                      tau=2, no_filter=False, multi=True):
    """place_read against a mapped placement tree."""
    k, h = oi.k, oi.h
    node_to_minfo, closest_se, closest, onmers = query_read_mapped(
        oi, seq, hdist_th, qtree_nodes)
    if not node_to_minfo or not (no_filter or closest.leq_tau(tau) > 1.0):
        return None
    if len(node_to_minfo) == 1:
        nd = qtree_nodes[closest_se]
        return [(nd.se, 1.0, closest.d, closest.v)]
    pp: Dict[int, OMinfo] = {}
    nodes = {}
    for se, mi in node_to_minfo.items():
        nd = qtree_nodes[se]
        pp[nd.se] = mi
        nodes[nd.se] = nd
        denom = 1.0
        p = nd.parent
        cur_leaf = nd
        while p is not None:
            if p.is_taxon and cur_leaf.is_taxon:
                denom = 1.0
            else:
                denom /= p.eff_nchildren
            if p.se not in pp:
                pp[p.se] = OMinfo(hdist_th)
            pp[p.se].add(mi, denom)
            nodes[p.se] = p
            p = p.parent
    cands = []
    for qse in sorted(pp):
        nd = nodes[qse]
        mi = pp[qse]
        if nd.nchildren != nd.eff_nchildren or nd.nchildren == 1:
            continue
        if no_filter or mi.leq_tau(tau) > 1.0:
            if not nd.is_leaf:
                mi.optimize(k, h, hdist_th)
            mi.chisq = closest.ratio_at(mi.d, k, h, hdist_th)
            if mi.chisq < chisq_value and nd.parent is not None:
                cands.append(qse)
    total = 0.0
    for qse in cands:
        pp[qse].lwr = math.exp(-pp[qse].chisq / 2)
        total += pp[qse].lwr
    if multi:
        return [(qse, pp[qse].lwr / total, pp[qse].d, pp[qse].v) for qse in cands]
    best = sorted(cands, key=lambda q: (nodes[q].card, -pp[q].d))[-1]
    return [(best, pp[best].lwr / total, pp[best].d, pp[best].v)]
