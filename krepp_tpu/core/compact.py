"""Mask-lane compaction without top_k.

lax.top_k over a 0/1 mask selects the first K set lanes (ties break by
ascending index) but costs O(N log K) — it dominates stage-2 at millions of
(read, leaf) lanes. The identical selection is one cumsum + one scatter.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _cumsum_1d(x):
    """Inclusive int32 cumsum; two-level blocked formulation.

    Reshaping to [rows, 4096] makes the inner scan a row-parallel axis-1
    cumsum plus a tiny row-offset scan."""
    N = x.shape[0]
    BLK = 4096
    if N <= BLK:
        return jnp.cumsum(x, dtype=jnp.int32)
    rows = (N + BLK - 1) // BLK
    xp = jnp.zeros((rows * BLK,), jnp.int32).at[:N].set(x.astype(jnp.int32))
    x2 = xp.reshape(rows, BLK)
    within = jnp.cumsum(x2, axis=1, dtype=jnp.int32)
    offs = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(within[:, -1], dtype=jnp.int32)[:-1]])
    return (within + offs[:, None]).reshape(-1)[:N]


def compact_mask_indices_strided(mask_flat, K: int, blk: int = 1024):
    """compact_mask_indices via a two-level sort for multi-million-lane
    masks: a per-block [nblk, blk] sort (row-parallel) keeps the first
    ceil(K/nblk) set lanes per block, then a small global sort of the
    survivors restores ascending order.

    Blocks sample lanes STRIDED (block b holds lanes b, b+nblk, ...), not
    contiguous: set lanes cluster in lane order (e.g. probe lanes of one
    repetitive read), and contiguous blocks overflowed their share on
    ordinary batches. Striding decorrelates the draws, so per-block counts
    are ~binomial and the caller-provided K margin covers them.

    Output is identical to compact_mask_indices unless a block still holds
    more set lanes than its share — reported through the extra `blk_over`
    flag (callers escalate capacity exactly as for n_set > K).

    Returns (idx [K] int32 ascending, n_set, blk_over)."""
    N = mask_flat.shape[0]
    nblk = (N + blk - 1) // blk
    # per-block share + a 5-sigma binomial margin: blocks are random
    # samples of the set lanes, so max-over-blocks sits ~4 sigma above the
    # mean share; the margin only widens the small [nblk, Kb] intermediate
    # (the caller's global K still bounds all downstream work), while a
    # margin miss costs a full capacity-tier re-run.
    share = max(8, -(-K // nblk))
    Kb = min(blk, share + int(5 * share ** 0.5) + 8)
    if N <= 4 * blk or K >= N or nblk * Kb >= N:
        idx, n_set = compact_mask_indices(mask_flat, K)
        return idx, n_set, jnp.bool_(False)
    Npad = nblk * blk
    mpad = (mask_flat if Npad == N else
            jnp.zeros((Npad,), bool).at[:N].set(mask_flat))
    gidx = (jax.lax.broadcasted_iota(jnp.int32, (blk, nblk), 0) * nblk
            + jax.lax.broadcasted_iota(jnp.int32, (blk, nblk), 1))
    keys = jnp.where(mpad.reshape(blk, nblk), gidx, jnp.int32(N)).T
    kept = jax.lax.sort(keys, dimension=1)[:, :Kb].reshape(-1)
    counts = jnp.sum(keys < N, axis=1, dtype=jnp.int32)
    blk_over = jnp.any(counts > Kb)
    idx = jax.lax.sort(kept)[:K]
    n_set = jnp.sum(counts)
    return idx, n_set, blk_over


def compact_mask_indices(mask_flat, K: int):
    """Indices of the first K set lanes of mask_flat, in ascending order.

    Returns (idx [K] int32, n_set). Unfilled slots hold the sentinel N
    (out of bounds): gathers through them clamp to junk that callers must
    ignore, and scatters through them drop (mode='drop').

    Formulated as a key sort of (set ? lane : N)."""
    N = mask_flat.shape[0]
    keys = jnp.where(mask_flat, jax.lax.iota(jnp.int32, N), jnp.int32(N))
    idx = jax.lax.sort(keys)[:K]
    n_set = jnp.sum(mask_flat.astype(jnp.int32))
    return idx, n_set
