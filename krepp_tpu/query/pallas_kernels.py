"""Pallas (Triton route) kernel for the hybrid probe epilogue.

The XLA epilogue (QueryEngine._dense_epilogue) expands every per-distance
leaf bitmask plane into a [N, P, S] 0/1 array before summing over the
positions. This kernel keeps one [TB, Pq] tile of strand-reads x positions
in registers, walks the S leaves in a loop (bit s % 32 of mask word
s // 32), and counts per-read first-match
classes as base-256 packed counters: classes 0-2 in word 0 at bits
0/8/16, classes 3-5 in word 1. Nothing of size [N, P, S] is built, and no
state passes between programs.

Every tensor the kernel loads or stores has power-of-two dimensions, as
Triton requires: positions pad with light = 0 (padding never matches) to a
multiple of 32 and are read in power-of-two chunks, leaves pad to Sp and the
distance classes to 8 in the output layout; the wrapper slices them off.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

HD_SENTINEL = 255
# strand-reads per program: a [16, 128] chunk is 2048 lanes, 16 per thread
# at four warps
TB = 16
# largest leaf count the engine hands to the kernel (more leaves than this
# have no bitmask table: they take the event probe)
MAX_LEAVES = 256


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _chunks(P: int):
    """[(start, width)]: power-of-two position chunks of at least 32 lanes
    covering P (164 -> 128 + 64), so a read's padded positions cost at most
    31 dark lanes instead of a pad to the next power of two."""
    out, start, rest = [], 0, -(-P // 32) * 32
    while rest:
        width = 1 << (rest.bit_length() - 1)
        out.append((start, width))
        start, rest = start + width, rest - width
    return out


def _popcount16(x):
    """Bit count of 16-bit values in u32 lanes, SWAR (Triton does not
    lower population_count)."""
    x = x - ((x >> 1) & jnp.uint32(0x5555))
    x = (x & jnp.uint32(0x3333)) + ((x >> 2) & jnp.uint32(0x3333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F)
    return ((x + (x >> 8)) & jnp.uint32(0x1F)).astype(jnp.int32)


def _packed_kernel(res_ref, light_ref, *refs, th: int, C0: int, W: int,
                   S: int, chunks):
    """One [TB, Pq] tile of strand-reads, read in power-of-two chunks.

    refs = C0 * (1 + W) entry planes (enc_c, then mask words 0..W-1 of
    candidate c), then the outputs min [TB] and hist [TB, Sp, 8]."""
    nent = C0 * (1 + W)
    min_ref, hist_ref = refs[nent:]
    X = th + 1
    xs = jax.lax.broadcasted_iota(jnp.int32, (TB, 8), 1)
    ents, hdg = [], []
    for start, width in chunks:
        sl = (slice(None), pl.ds(start, width))
        ent = [r[sl] for r in refs[:nent]]
        res = res_ref[sl]
        light = light_ref[sl] != 0
        # per-candidate gated Hamming distance (ref:
        # src/common.hpp:157-175); X marks "no match"
        hd_c = []
        for c in range(C0):
            z = jnp.bitwise_xor(ent[c * (1 + W)], res)
            folded = jnp.bitwise_and(jnp.bitwise_or(z, z >> 16),
                                     jnp.uint32(0xFFFF))
            hd = _popcount16(folded)
            hd_c.append(jnp.where((hd <= th) & light, hd, jnp.int32(X)))
        ents.append(ent)
        hdg.append(hd_c)

    def leaf(s, gm):
        w = s // jnp.int32(32)
        b = (s % jnp.int32(32)).astype(jnp.uint32)
        w0 = w1 = None
        gm = list(gm)
        for i, (ent, hd_c) in enumerate(zip(ents, hdg)):
            # per-(position, leaf) minimum class = the reference's
            # first-match dedupe (ref: src/query.hpp:153-176)
            mh = None
            for c in range(C0):
                word = ent[c * (1 + W) + 1]
                for wi in range(1, W):
                    word = jnp.where(w == jnp.int32(wi),
                                     ent[c * (1 + W) + 1 + wi], word)
                bit = (word >> b) & jnp.uint32(1)
                h = jnp.where(bit != 0, hd_c[c], jnp.int32(X))
                mh = h if mh is None else jnp.minimum(mh, h)
            gm[i] = jnp.minimum(gm[i], mh)
            # shift amounts clamped so both select branches stay defined
            sh0 = jnp.minimum(8 * mh, 16)
            sh1 = jnp.clip(8 * (mh - 3), 0, 16)
            e0 = jnp.where(mh < 3, jnp.int32(1) << sh0, jnp.int32(0))
            e1 = jnp.where((mh >= 3) & (mh < X), jnp.int32(1) << sh1,
                           jnp.int32(0))
            p0 = jnp.sum(e0, axis=1, dtype=jnp.int32)
            p1 = jnp.sum(e1, axis=1, dtype=jnp.int32)
            w0 = p0 if w0 is None else w0 + p0
            w1 = p1 if w1 is None else w1 + p1
        word = jnp.where(xs < 3, w0[:, None], w1[:, None])
        off = jnp.where(xs < 3, 8 * xs, 8 * (xs - 3))
        cnt = (word >> off) & jnp.int32(255)
        hist_ref[:, pl.ds(s, 1), :] = jnp.where(xs < X, cnt,
                                                jnp.int32(0))[:, None, :]
        return tuple(gm)

    # a loop, not an unrolled leaf walk: the kernel's size and compile time
    # stay independent of S
    gm = jax.lax.fori_loop(
        jnp.int32(0), jnp.int32(S), leaf,
        tuple(jnp.full((TB, width), X, jnp.int32) for _s, width in chunks))
    mins = [jnp.min(g, axis=1) for g in gm]
    min_ref[...] = functools.reduce(jnp.minimum, mins)


@functools.partial(jax.jit, static_argnames=("th", "C0", "W", "S",
                                             "interpret"))
def probe_hist_packed(res: jax.Array, light: jax.Array, ents, th: int,
                      C0: int, W: int, S: int, interpret: bool = False):
    """Packed-counter epilogue over [N, P] planes.

    res [N, P] u32; light [N, P] bool; ents = C0 * (1 + W) planes [N, P]
    u32 (enc_c, then the W mask words of candidate c). Counts must fit 8
    bits (P <= 255) and the classes two words (th + 1 <= 6). Returns
    (hist [N, S, th+1] i32, minall [N] i32, HD_SENTINEL where unmatched)."""
    N, P = res.shape
    X = th + 1
    if X > 6 or P > 255 or S > MAX_LEAVES or len(ents) != C0 * (1 + W):
        raise ValueError(f"packed epilogue cannot take th={th} P={P} S={S}")
    chunks = tuple(_chunks(P))
    Pq = sum(width for _start, width in chunks)
    Sp = _next_pow2(S)
    Np = -(-N // TB) * TB

    def pad(a):
        return jnp.pad(a.astype(jnp.uint32), ((0, Np - N), (0, Pq - P)))

    planes = [pad(res), pad(light)] + [pad(e) for e in ents]
    tile = pl.BlockSpec((TB, Pq), lambda i: (i, 0))
    minall, hist = pl.pallas_call(
        functools.partial(_packed_kernel, th=th, C0=C0, W=W, S=S,
                          chunks=chunks),
        grid=(Np // TB,),
        in_specs=[tile] * len(planes),
        out_specs=[pl.BlockSpec((TB,), lambda i: (i,)),
                   pl.BlockSpec((TB, Sp, 8), lambda i: (i, 0, 0))],
        out_shape=[jax.ShapeDtypeStruct((Np,), jnp.int32),
                   jax.ShapeDtypeStruct((Np, Sp, 8), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="probe_hist_packed",
    )(*planes)
    minall = minall[:N]
    return hist[:N, :S, :X], jnp.where(minall >= X, HD_SENTINEL, minall)
