"""Synthetic-data helpers: generated phylogenies of mutated genomes,
in-memory index builds, read samplers, and the plain reference of the
probe-epilogue kernel. Used by tests, chip_smoke.py and bench.py (no
filesystem or network required).

Two representations: small string worlds (make_world) for oracle tests, and
vectorized base-code worlds (make_world_codes) for benchmark-scale data.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .params import IndexParams, LSHParams
from .index.build import build_index_from_sources
from .tree.newick import Tree

BASES = "ACGT"


def mutate(rng, seq: str, rate: float) -> str:
    out = list(seq)
    n_mut = rng.binomial(len(seq), rate)
    for pos in rng.choice(len(seq), size=n_mut, replace=False):
        out[pos] = BASES[(BASES.index(out[pos]) + rng.integers(1, 4)) % 4]
    return "".join(out)


def mutate_codes(rng, codes: np.ndarray, rate: float) -> np.ndarray:
    mask = rng.random(codes.shape) < rate
    shift = rng.integers(1, 4, size=codes.shape)
    return np.where(mask & (codes < 4), (codes + shift) % 4,
                    codes).astype(np.uint8)


def _world_split(names, seq, depth, rng, rate, mut_fn):
    if len(names) == 1:
        return f"{names[0]}:{0.05 + 0.01 * depth:.4f}", {names[0]: [seq]}
    half = len(names) // 2
    lnwk, lgen = _world_split(names[:half], mut_fn(rng, seq, rate), depth + 1,
                              rng, rate, mut_fn)
    rnwk, rgen = _world_split(names[half:], mut_fn(rng, seq, rate), depth + 1,
                              rng, rate, mut_fn)
    lgen.update(rgen)
    return f"({lnwk},{rnwk}):{0.02 + 0.005 * depth:.4f}", lgen


def make_world(rng, nleaves=6, glen=2000, rate=0.04) -> Tuple[str, Dict[str, List[str]]]:
    """String genomes (small scale, oracle tests)."""
    root = "".join(rng.choice(list(BASES), size=glen))
    names = [f"G{i:03d}" for i in range(nleaves)]
    nwk, genomes = _world_split(names, root, 0, rng, rate, mutate)
    return nwk.rsplit(":", 1)[0] + ";", genomes


def make_world_codes(rng, nleaves=12, glen=500_000, rate=0.04):
    """Base-code genomes (vectorized, benchmark scale)."""
    root = rng.integers(0, 4, size=glen).astype(np.uint8)
    names = [f"G{i:03d}" for i in range(nleaves)]
    nwk, genomes = _world_split(names, root, 0, rng, rate, mutate_codes)
    return nwk.rsplit(":", 1)[0] + ";", genomes


def sample_reads(rng, genomes, n=20, rlen=150, mut=0.05, with_n=2,
                 with_garbage=2):
    """String reads from string genomes (oracle tests)."""
    names = sorted(genomes)
    reads = []
    for i in range(n):
        g = names[rng.integers(len(names))]
        seq = genomes[g][0]
        start = rng.integers(0, len(seq) - rlen)
        r = mutate(rng, seq[start: start + rlen], mut)
        if i < with_n:
            r = list(r)
            for pos in rng.choice(rlen, size=3, replace=False):
                r[pos] = "N"
            r = "".join(r)
        reads.append((f"read{i}", r))
    for j in range(with_garbage):
        reads.append((f"garbage{j}",
                      "".join(rng.choice(list(BASES), size=rlen))))
    return reads


def sample_read_codes(rng, genomes_codes: Dict[str, List[np.ndarray]], n: int,
                      rlen: int = 150, mut: float = 0.05) -> np.ndarray:
    """Vectorized [n, rlen] uint8 reads from code genomes."""
    gl = [genomes_codes[g][0] for g in sorted(genomes_codes)]
    out = np.empty((n, rlen), np.uint8)
    for i in range(n):
        g = gl[rng.integers(len(gl))]
        start = rng.integers(0, len(g) - rlen)
        out[i] = g[start: start + rlen]
    mask = rng.random(out.shape) < mut
    out = np.where(mask, (out + rng.integers(1, 4, size=out.shape)) % 4,
                   out).astype(np.uint8)
    return out


def build_world_index(seed=0, nleaves=6, glen=2000, rate=0.05,
                      k=27, h=11, w=35, m=4, r=1, frac=True):
    """Generate a code world and build its index fully in memory.

    Returns (BuiltIndex, genomes as code arrays, tree).
    """
    rng = np.random.default_rng(seed)
    nwk, genomes = make_world_codes(rng, nleaves=nleaves, glen=glen, rate=rate)
    tree = Tree.parse(nwk)
    params = IndexParams(lsh=LSHParams.generate(k, h, m, seed=seed),
                         w=w, r=r, frac=frac)
    names = sorted(genomes)
    sources = {n: (lambda n=n: iter(genomes[n])) for n in names}
    built = build_index_from_sources(names, sources, params, tree,
                                     progress=False)
    return built, genomes, tree


def epilogue_planes(seed, N, P, C0, W, S):
    """Random probe-epilogue inputs (query/pallas_kernels.py layout) with
    planted near matches, empty slots and dark lanes: (res [N, P] u32,
    light [N, P] bool, C0 * (1 + W) entry planes [N, P] u32)."""
    rng = np.random.default_rng(seed)
    res = rng.integers(0, 2 ** 32, (N, P), dtype=np.uint32)
    light = rng.random((N, P)) < 0.8
    ents = []
    for _c in range(C0):
        noise = np.zeros((N, P), np.uint32)
        for j in range(3):
            # each flip lands in the folded 16 bits (bit i or i + 16)
            bit = rng.integers(0, 16, (N, P)) + 16 * (j % 2)
            noise ^= np.left_shift(np.uint32(1), bit.astype(np.uint32))
        noise *= (rng.random((N, P)) < 0.7).astype(np.uint32)
        enc = np.where(rng.random((N, P)) < 0.6, res ^ noise,
                       rng.integers(0, 2 ** 32, (N, P), dtype=np.uint32))
        ents.append(enc.astype(np.uint32))
        for w in range(W):
            nbits = min(32, S - 32 * w)
            m = rng.integers(0, 2 ** 32, (N, P), dtype=np.uint32)
            m &= np.uint32((1 << nbits) - 1)
            m[rng.random((N, P)) < 0.2] = 0
            ents.append(m)
    return res, light, ents


_POPCOUNT16 = np.array([bin(i).count("1") for i in range(1 << 16)], np.int32)


def epilogue_reference(res, light, ents, th, C0, W, S):
    """numpy probe epilogue: per-(read, leaf) histogram of first-match
    classes (the minimum Hamming distance per position and leaf, ref:
    src/query.hpp:153-176) and the per-read min matched distance (255 when
    none)."""
    N, P = res.shape
    X = th + 1
    mh = np.full((N, P, S), X, np.int32)
    minall = np.full(N, 255, np.int32)
    for c in range(C0):
        z = ents[c * (1 + W)] ^ res
        hd = _POPCOUNT16[(z | (z >> np.uint32(16))) & np.uint32(0xFFFF)]
        ok = (hd <= th) & light
        for s in range(S):
            w, b = divmod(s, 32)
            bit = (ents[c * (1 + W) + 1 + w] >> np.uint32(b)) & np.uint32(1)
            hit = ok & (bit != 0)
            mh[..., s] = np.where(hit, np.minimum(mh[..., s], hd),
                                  mh[..., s])
            minall = np.minimum(minall, np.where(hit, hd, 255).min(axis=1))
    hist = np.stack([(mh == x).sum(axis=1, dtype=np.int32)
                     for x in range(X)], axis=-1)
    return hist, minall


def check_epilogue_kernel(N=4096, P=164, th=4):
    """Compiled probe-epilogue kernel against epilogue_reference at read
    width (150 bp reads padded to 192 bases, k=29) for one and three mask
    words; raises on any difference."""
    import jax.numpy as jnp

    from .query.pallas_kernels import probe_hist_packed

    for W, S in ((1, 24), (3, 96)):
        res, light, ents = epilogue_planes(W, N, P, 2, W, S)
        hist, minall = probe_hist_packed(
            jnp.asarray(res), jnp.asarray(light),
            [jnp.asarray(e) for e in ents], th, 2, W, S)
        ref_h, ref_m = epilogue_reference(res, light, ents, th, 2, W, S)
        if not (np.array_equal(np.asarray(hist), ref_h)
                and np.array_equal(np.asarray(minall), ref_m)):
            raise AssertionError(f"epilogue kernel differs at W={W} S={S}")
