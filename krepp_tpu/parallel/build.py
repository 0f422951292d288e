"""Data-parallel index build: genome winnowing sharded across mesh devices.

The reference parallelizes the build with one OpenMP task per tree node,
unioning child tables under locks (ref: src/krepp.cpp:248-303,
src/table.cpp:182-232). The build here instead:

  * cuts every contig into halo-overlapped tiles (the same tiling as the
    single-device chunked winnower — each emit position is computed by
    exactly one tile with its full minimizer window in view, SURVEY §5.7),
  * winnows batches of tiles data-parallel across the device mesh (one
    vmapped XLA program; the batch axis is sharded, tiles are independent
    so no collectives are needed),
  * merges per-contig HLL registers and per-genome entries on the host and
    feeds the shared sort-and-group union (index/build.py).

Results are bit-identical to the sequential build: identical tile
semantics, identical HLL register maxima, identical (row, residual) sets.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..params import IndexParams
from ..core import winnow_device as wd
from ..core.hll import HyperLogLog
from ..core.minimizer import _round_len
from ..index.build import (BuiltIndex, _prepare_tree,
                           build_index_from_extracted)
from ..tree.newick import Tree

# tiles per device per launch: bounds host batch memory (TILE_GROUP * TL
# bytes per device) while amortizing dispatch overhead
TILE_GROUP = 8


def _winnow_tiles(codes, n_real, t_lo, do_final, lsh, w, r, frac):
    """vmapped winnow over a [T, TL] tile batch (T sharded over devices)."""
    import jax

    def one(c, n, t, f):
        return wd.winnow_device(c, n, lsh, w, r, frac, t, f)

    return jax.vmap(one)(codes, n_real, t_lo, do_final)


def _contig_tiles(codes: np.ndarray, params: IndexParams):
    """Cut one contig into (start, slice_len, t_lo, do_final) tile specs.

    Mirrors winnow_device.extract_sequence_mers_device's chunked path; a
    None return means the contig needs the exact host fallback (pathological
    trailing N-runs starve the end-of-sequence window, see there)."""
    k = params.lsh.k
    w = max(params.w, k)
    ldiff = w - k + 1
    n = len(codes)
    if _round_len(n) <= wd._CHUNK:
        return [(0, n, 0, True)]
    left = w - k
    span = wd._CHUNK - left - k + 1
    P_global = n - k + 1
    tiles = list(range(0, P_global, span))
    f_start = max(tiles[-1] - left, 0)
    tail = codes[f_start:]
    bad = (tail >= 4).astype(np.int32)
    cbad = np.concatenate([[0], np.cumsum(bad)])
    tail_valid = int(((cbad[k:] - cbad[:-k]) == 0).sum()) if len(tail) >= k else 0
    if tail_valid < ldiff:
        return None
    specs = []
    for a in tiles:
        b = min(a + span, P_global)
        start = a - left if a > 0 else 0
        specs.append((start, b + k - 1 - start, a - start, b == P_global))
    return specs


def winnow_genomes_sharded(names: List[str], contig_source,
                           params: IndexParams, devices=None,
                           progress: bool = True):
    """Winnow many genomes across a device mesh.

    Yields (name, rows, res, rho) in input order — the same contract as the
    sequential extraction loop, bit-identical output."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devices = list(devices if devices is not None else jax.devices())
    D = len(devices)
    mesh = Mesh(np.asarray(devices), ("dev",))
    sh2 = NamedSharding(mesh, P("dev"))

    k = params.lsh.k
    w = max(params.w, k)

    # ---- work list: (genome, contig, tile) specs + host-fallback contigs
    contigs: Dict[Tuple[int, int], np.ndarray] = {}
    items = []               # (gi, ci, start, slen, t_lo, final)
    fallback: List[Tuple[int, int]] = []
    ncontigs: Dict[int, int] = {}
    present = []
    for gi, name in enumerate(names):
        if name not in contig_source:
            continue
        present.append(gi)
        ci = 0
        for codes in contig_source[name]():
            codes = np.asarray(codes, np.uint8)
            if len(codes) < w:
                continue
            contigs[(gi, ci)] = codes
            specs = _contig_tiles(codes, params)
            if specs is None:
                fallback.append((gi, ci))
            else:
                for (start, slen, t_lo, fin) in specs:
                    items.append((gi, ci, start, slen, t_lo, fin))
            ci += 1
        ncontigs[gi] = ci

    rows_of: Dict[Tuple[int, int], List[np.ndarray]] = {}
    c1_of: Dict[Tuple[int, int], np.ndarray] = {}
    c2_of: Dict[Tuple[int, int], np.ndarray] = {}

    if items:
        TL = min(wd._CHUNK, max(_round_len(i[3]) for i in items))
        group = D * TILE_GROUP
        for g0 in range(0, len(items), group):
            batch = items[g0: g0 + group]
            Bt = ((len(batch) + D - 1) // D) * D
            codes_b = np.full((Bt, TL), 4, np.uint8)
            n_real = np.zeros(Bt, np.int32)
            t_lo = np.zeros(Bt, np.int32)
            fin = np.zeros(Bt, bool)
            for i, (gi, ci, start, slen, tl, fn) in enumerate(batch):
                codes_b[i, :slen] = contigs[(gi, ci)][start: start + slen]
                n_real[i] = slen
                t_lo[i] = tl
                fin[i] = fn
            out = _winnow_tiles(
                jax.device_put(codes_b, NamedSharding(mesh, P("dev", None))),
                jax.device_put(n_real, sh2), jax.device_put(t_lo, sh2),
                jax.device_put(fin, sh2),
                params.lsh, params.w, params.r, params.frac)
            crow, cres, nuniq, c1reg, c2reg = jax.device_get(out)
            for i, (gi, ci, *_rest) in enumerate(batch):
                nu = int(nuniq[i])
                key = (gi, ci)
                rows_of.setdefault(key, []).append(
                    np.stack([crow[i, :nu], cres[i, :nu]]))
                c1 = c1reg[i].astype(np.uint8)
                c2 = c2reg[i].astype(np.uint8)
                if key in c1_of:
                    np.maximum(c1_of[key], c1, out=c1_of[key])
                    np.maximum(c2_of[key], c2, out=c2_of[key])
                else:
                    c1_of[key], c2_of[key] = c1, c2

    for key in fallback:
        out = wd.extract_sequence_mers_device(contigs[key], params)
        if out is None:
            continue
        rows, res, c1, c2 = out
        rows_of[key] = [np.stack([rows, res])]
        c1_of[key], c2_of[key] = c1, c2

    done = 0
    for gi in present:
        name = names[gi]
        all_rows, all_res = [], []
        n1 = n2 = 0.0
        for ci in range(ncontigs.get(gi, 0)):
            key = (gi, ci)
            if key not in rows_of:
                continue
            pieces = rows_of.pop(key)
            for p in pieces:
                all_rows.append(p[0])
                all_res.append(p[1])
            h1 = HyperLogLog(wd._HLL_B)
            h1.M = c1_of.pop(key)
            h2 = HyperLogLog(wd._HLL_B)
            h2.M = c2_of.pop(key)
            n1 += h1.estimate()
            n2 += h2.estimate()
        rows = np.concatenate(all_rows) if all_rows else np.empty(0, np.uint32)
        res = np.concatenate(all_res) if all_res else np.empty(0, np.uint32)
        rho = (n2 / n1) if n1 > 0 else 0.0
        done += 1
        if progress:
            print(f"Leaf node: {name}\tsize: {len(rows)}\t"
                  f"progress: {done}/{len(present)} (mesh x{D})",
                  file=sys.stderr)
        yield name, rows, res, rho


def build_index_sharded(input_map, params: IndexParams,
                        tree: Optional[Tree] = None, devices=None,
                        progress: bool = True) -> BuiltIndex:
    """Mesh-data-parallel build front end; bit-identical to build_index."""
    from ..io.fastx import read_genome_codes

    names = [n for n, _ in input_map]
    path_of = dict(input_map)
    sources = {n: (lambda p=path_of[n]: read_genome_codes(p))
               for n in names if n in path_of}
    tree, ftree, leaf_se = _prepare_tree(names, tree)
    extracted = winnow_genomes_sharded(names, sources, params,
                                       devices=devices, progress=progress)
    return build_index_from_extracted(names, extracted, params, tree,
                                      ftree, leaf_se)
