"""Vectorized k-mer codec: base codes -> LSH rows, residual encodings, bp bits.

The reference packs k-mers into 64-bit integers and uses
BMI2 PEXT / rolling updates (ref: src/common.hpp:225-243, src/lshf.cpp:61-71).
Here a sequence is an int32 vector of base codes (A=0, C=1, G=2, T=3, N/other=4)
and every per-k-mer quantity is a sum of statically-shifted slices — pure
elementwise work with no gathers, no 64-bit integers on the
query path, and no sequential dependence between positions.

Bit-position convention (matches the reference): for the k-mer ending at
sequence index e (0-based, spanning s[e-k+1 .. e]), "bit-position" j in
ppos/npos refers to base s[e - j]; i.e. position 0 is the k-mer's rightmost
base (ref: src/common.hpp:225-243 packs base at k-mer offset p into bits
2*(k-1-p)).

Derived quantities, with t = e - (k - 1) indexing the P = L-k+1 windows:

  hash(t)   = sum_r codes[t + k-1 - p_r] * 4^r          (p_r = ppos ascending)
              == PEXT(bp64, mask over ppos)             (ref: src/lshf.cpp:62)
  res(t)    = sum_r  (codes[..n_r] & 1) << r
            | sum_r  (codes[..n_r] >> 1) << (16 + r)    (n_r = npos ascending)
              == PEXT(lr64, mask over npos)             (ref: src/lshf.cpp:64-69)
  rc_hash(t)= sum_r (3 - codes[t + p_r]) * 4^r          (reverse complement:
              rc base at bit-position j = 3 - base at bit-position k-1-j,
              ref: src/common.hpp:177-186)
  rc_res(t) similarly with npos.

Hamming distance between two residuals r1, r2 over the k-h npos positions is
popcount(((z | z>>16) & 0xffff)) with z = r1 ^ r2 (ref: src/common.hpp:169-175).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..params import LSHParams

# ASCII -> base code table (ref: src/common.cpp:10-14): ACGT/acgt -> 0..3,
# everything else -> 4.
SEQ_NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    SEQ_NT4_TABLE[ord(_c)] = _i
    SEQ_NT4_TABLE[ord(_c.lower())] = _i


def seq_to_codes(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> uint8 base codes (host side)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return SEQ_NT4_TABLE[np.frombuffer(seq, dtype=np.uint8)]


def codes_to_seq(codes: np.ndarray) -> str:
    return "".join("ACGTN"[c] for c in codes)


def pad_codes_batch(code_list, pad_to: int | None = None) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-length code vectors into [B, Lmax] padded with 4 (=N).

    Padding with N keeps windows that overrun a read automatically invalid.
    Returns (codes[B, Lmax] uint8, lengths[B] int32).
    """
    lengths = np.array([len(c) for c in code_list], dtype=np.int32)
    lmax = int(pad_to if pad_to is not None else (lengths.max() if len(lengths) else 1))
    out = np.full((len(code_list), lmax), 4, dtype=np.uint8)
    for i, c in enumerate(code_list):
        out[i, : len(c)] = c
    return out, lengths


def pack_codes_host(codes: np.ndarray, lengths: np.ndarray):
    """[B, L] uint8 base codes -> (packed u32 [B, ceil(L/16)], vbits or None).

    2-bit packing cuts the per-batch host-to-device copy 4x. vbits (one validity bit per
    base) is returned only when some read contains a non-ACGT code inside
    its length — for the common all-ACGT batch the per-read `lengths` alone
    reconstruct validity.
    """
    from .native_sort import pack_codes as _native_pack

    native = _native_pack(codes, lengths)
    if native is not None:
        return native
    B, L = codes.shape
    W = (L + 15) // 16
    c = np.where(codes < 4, codes, 0).astype(np.uint32)
    cp = np.zeros((B, W * 16), np.uint32)
    cp[:, :L] = c
    cp = cp.reshape(B, W, 16)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    packed = np.bitwise_or.reduce(cp << shifts, axis=2)
    inv = (codes >= 4) & (np.arange(L)[None, :] < np.asarray(lengths)[:, None])
    if not bool(inv.any()):
        return packed, None
    v = (~inv).astype(np.uint32)
    Wv = (L + 31) // 32
    vp = np.zeros((B, Wv * 32), np.uint32)
    vp[:, :L] = v
    vp = vp.reshape(B, Wv, 32)
    vshift = np.arange(32, dtype=np.uint32)[None, None, :]
    vbits = np.bitwise_or.reduce(vp << vshift, axis=2)
    return packed, vbits


def unpack_codes(packed: jax.Array, lengths: jax.Array, L: int,
                 vbits: jax.Array | None = None) -> jax.Array:
    """Device-side inverse of pack_codes_host -> [B, L] int32 codes.

    Positions >= lengths (or with vbits == 0) decode to 4 (invalid).
    int32 output: every consumer computes in int32."""
    B, W = packed.shape
    p32 = jax.lax.bitcast_convert_type(packed, jnp.int32)
    shifts = jnp.asarray((2 * np.arange(16)).astype(np.int32))
    ex = (p32[:, :, None] >> shifts[None, None, :]) & jnp.int32(3)
    ex = ex.reshape(B, W * 16)[:, :L]
    pos = jnp.arange(L, dtype=jnp.int32)
    ok = pos[None, :] < lengths[:, None]
    if vbits is not None:
        v32 = jax.lax.bitcast_convert_type(vbits, jnp.int32)
        vshifts = jnp.asarray(np.arange(32).astype(np.int32))
        vb = (v32[:, :, None] >> vshifts[None, None, :]) & jnp.int32(1)
        ok = ok & (vb.reshape(B, -1)[:, :L] == 1)
    return jnp.where(ok, ex, jnp.int32(4))


def pack_bits_device(flags: jax.Array) -> jax.Array:
    """bool [..., S] -> u32 [..., ceil(S/32)] bitmap (bit j of word w =
    flag[w*32+j]); used to shrink per-read boolean fetches."""
    S = flags.shape[-1]
    Wp = (S + 31) // 32
    pad = Wp * 32 - S
    f = jnp.pad(flags, [(0, 0)] * (flags.ndim - 1) + [(0, pad)])
    f = f.reshape(flags.shape[:-1] + (Wp, 32)).astype(jnp.uint32)
    sh = jnp.asarray(np.arange(32).astype(np.uint32))
    return jnp.sum(f << sh, axis=-1, dtype=jnp.uint32)


def unpack_bits_host(words: np.ndarray, S: int) -> np.ndarray:
    """Inverse of pack_bits_device on the host."""
    w = np.asarray(words)
    bits = (w[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(w.shape[:-1] + (-1,))[..., :S].astype(bool)


@functools.partial(jax.jit, static_argnames=("k",))
def window_valid(codes: jax.Array, k: int) -> jax.Array:
    """valid[..., t] = all of codes[..., t : t+k] are ACGT (code < 4).

    Equivalent to the reference's run-length counter l >= k
    (ref: src/query.cpp:49-57). Output has P = L-k+1 positions.
    """
    bad = (codes >= 4).astype(jnp.int32)
    c = jnp.cumsum(bad, axis=-1)
    czero = jnp.concatenate(
        [jnp.zeros(c.shape[:-1] + (1,), jnp.int32), c], axis=-1)
    return (czero[..., k:] - czero[..., :-k]) == 0


def _shifted_sum(codes: jax.Array, offsets, weights, dtype) -> jax.Array:
    """sum_r transform(codes[..., t + offsets[r]]) * weights[r] over windows t.

    offsets/weights are static python sequences; each term is a static slice,
    so XLA fuses the whole thing into one elementwise loop.
    """
    L = codes.shape[-1]
    k_span = max(offsets) + 1
    P = L - k_span + 1
    acc = jnp.zeros(codes.shape[:-1] + (P,), dtype)
    for off, wgt in zip(offsets, weights):
        acc = acc + codes[..., off: off + P].astype(dtype) * dtype(wgt)
    return acc


@functools.partial(jax.jit, static_argnames=("lsh",))
def lsh_hash_or(codes: jax.Array, lsh: LSHParams) -> jax.Array:
    """Forward-strand LSH bucket row per window, uint32 [..., P]."""
    k = lsh.k
    offs = [k - 1 - p for p in lsh.ppos]
    wgts = [4 ** r for r in range(lsh.h)]
    # ppos ascending -> rank r ascending; any offset order works since the
    # slice span is determined by max offset = k-1 (position 0 always exists
    # in npos or ppos). Force span to k by including a zero-weight endpoint.
    return _padded_window_sum(codes, offs, wgts, k)


@functools.partial(jax.jit, static_argnames=("lsh",))
def lsh_hash_rc(codes: jax.Array, lsh: LSHParams) -> jax.Array:
    """Reverse-complement-strand LSH bucket row per window, uint32 [..., P]."""
    k = lsh.k
    offs = [p for p in lsh.ppos]
    # rc base at bit-position p = 3 - codes[t + p]; constant part sums to
    # 3 * sum(4^r) and the variable part is -codes[t+p] * 4^r.
    wgts = [-(4 ** r) for r in range(lsh.h)]
    const = sum(3 * 4 ** r for r in range(lsh.h))
    return _padded_window_sum(codes, offs, wgts, k, const)


@functools.partial(jax.jit, static_argnames=("lsh",))
def residual_or(codes: jax.Array, lsh: LSHParams) -> jax.Array:
    """Forward-strand 32-bit lr residual over npos, uint32 [..., P]."""
    k = lsh.k
    nres = len(lsh.npos)
    offs = [k - 1 - n for n in lsh.npos]
    low = _padded_window_sum_bits(codes, offs, list(range(nres)), k, low_bit=True)
    high = _padded_window_sum_bits(codes, offs, [16 + r for r in range(nres)], k, low_bit=False)
    return low + high


@functools.partial(jax.jit, static_argnames=("lsh",))
def residual_rc(codes: jax.Array, lsh: LSHParams) -> jax.Array:
    """Reverse-complement-strand 32-bit lr residual, uint32 [..., P].

    rc base value = 3 - b, so low bit = 1 - (b & 1) = (b & 1) ^ 1 and high
    bit = 1 - (b >> 1) (for b in 0..3).
    """
    k = lsh.k
    nres = len(lsh.npos)
    offs = [n for n in lsh.npos]
    low = _padded_window_sum_bits(codes, offs, list(range(nres)), k,
                                  low_bit=True, complement=True)
    high = _padded_window_sum_bits(codes, offs, [16 + r for r in range(nres)], k,
                                   low_bit=False, complement=True)
    return low + high


@functools.partial(jax.jit, static_argnames=("lsh",))
def strand_hashes_conv(codes: jax.Array, lsh: LSHParams):
    """All per-window hash quantities as ONE convolution.

    Every LSH quantity is a weighted sum over a k-base window — i.e. a 1-D
    convolution of the code channels with static integer weights: one pass
    over the codes instead of the ~100 slice sums of the formulation above.

    Exactness: weights are split into 8-bit chunks (see below); chunks
    recombine in int32.

    Returns (rix_or, rix_rc, res_or, res_rc, valid), each [..., P], matching
    lsh_hash_or/lsh_hash_rc/residual_or/residual_rc/window_valid bit-for-bit
    on windows without N bases (invalid windows are masked by `valid`
    everywhere downstream, exactly as with the slice formulation).
    """
    k, h = lsh.k, lsh.h
    nres = len(lsh.npos)

    # input channels: codes, low bit, high bit, is-invalid
    c = codes.astype(jnp.float32)
    c1 = (codes & 1).astype(jnp.float32)
    c2 = (codes >> 1).astype(jnp.float32)
    c3 = (codes >= 4).astype(jnp.float32)
    x = jnp.stack([c, c1, c2, c3], axis=-2)          # [..., 4, L]

    # output channel table: (in_channel, {offset: weight}) per 8-bit chunk.
    # 8-bit chunks keep every weight <= 255 — exactly representable in
    # bfloat16 — so ONE bf16 pass with f32 accumulation is exact: inputs
    # (codes <= 4) and weights are exact bf16 values, products (<= 1020)
    # accumulate exactly in the f32 accumulator, and window sums stay far
    # below 2^24.
    specs = []

    def add_chunked(cin, terms):
        """terms: list of (offset, weight). Returns list of channel ids with
        their chunk shifts."""
        out = []
        for chunk in range(4):
            wmap = {}
            for off, wgt in terms:
                part = (wgt >> (8 * chunk)) & 0xFF
                if part:
                    wmap[off] = wmap.get(off, 0) + part
            if wmap:
                specs.append((cin, wmap))
                out.append((len(specs) - 1, 8 * chunk))
        if not out:
            specs.append((cin, {0: 0}))
            out.append((len(specs) - 1, 0))
        return out

    ch_rix_or = add_chunked(0, [(k - 1 - p, 4 ** r)
                                for r, p in enumerate(lsh.ppos)])
    ch_rix_rc = add_chunked(0, [(p, 4 ** r) for r, p in enumerate(lsh.ppos)])
    ch_lo_or = add_chunked(1, [(k - 1 - n, 1 << r)
                               for r, n in enumerate(lsh.npos)])
    ch_hi_or = add_chunked(2, [(k - 1 - n, 1 << r)
                               for r, n in enumerate(lsh.npos)])
    ch_lo_rc = add_chunked(1, [(n, 1 << r) for r, n in enumerate(lsh.npos)])
    ch_hi_rc = add_chunked(2, [(n, 1 << r) for r, n in enumerate(lsh.npos)])
    specs.append((3, {off: 1 for off in range(k)}))  # N-count for validity
    ch_bad = len(specs) - 1

    W = np.zeros((len(specs), 4, k), np.float32)
    for o, (cin, wmap) in enumerate(specs):
        for off, wgt in wmap.items():
            W[o, cin, off] = wgt

    lead = x.shape[:-2]
    xin = x.reshape((-1,) + x.shape[-2:]).astype(jnp.bfloat16)
    out = jax.lax.conv_general_dilated(
        xin, jnp.asarray(W).astype(jnp.bfloat16), window_strides=(1,),
        padding="VALID", dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.DEFAULT,   # bf16 operands are exact
        preferred_element_type=jnp.float32)
    out = out.reshape(lead + out.shape[-2:])          # [..., OutC, P]

    def chunks_to_i32(chs):
        acc = None
        for idx, shift in chs:
            v = out[..., idx, :].astype(jnp.int32) << shift
            acc = v if acc is None else acc + v
        return acc

    rix_or = chunks_to_i32(ch_rix_or).astype(jnp.uint32)
    rc_const = sum(3 * 4 ** r for r in range(h))
    rix_rc = (jnp.int32(rc_const) - chunks_to_i32(ch_rix_rc)).astype(jnp.uint32)
    res_or = (chunks_to_i32(ch_lo_or)
              + (chunks_to_i32(ch_hi_or) << 16)).astype(jnp.uint32)
    full = (1 << nres) - 1
    res_rc = ((jnp.int32(full) - chunks_to_i32(ch_lo_rc))
              + ((jnp.int32(full) - chunks_to_i32(ch_hi_rc)) << 16)
              ).astype(jnp.uint32)
    valid = out[..., ch_bad, :] == 0.0
    return rix_or, rix_rc, res_or, res_rc, valid


def _padded_window_sum(codes, offs, wgts, k, const: int = 0):
    """Weighted sum of slices with the window span forced to k."""
    L = codes.shape[-1]
    P = L - k + 1
    acc = jnp.full(codes.shape[:-1] + (P,), const, jnp.int64 if False else jnp.uint32)
    c = codes.astype(jnp.uint32)
    for off, wgt in zip(offs, wgts):
        acc = acc + c[..., off: off + P] * jnp.uint32(wgt & 0xFFFFFFFF)
    return acc


def _padded_window_sum_bits(codes, offs, shifts, k, low_bit: bool, complement: bool = False):
    L = codes.shape[-1]
    P = L - k + 1
    acc = jnp.zeros(codes.shape[:-1] + (P,), jnp.uint32)
    c = codes.astype(jnp.uint32)
    for off, sh in zip(offs, shifts):
        b = c[..., off: off + P]
        bit = (b & 1) if low_bit else (b >> 1)
        if complement:
            bit = bit ^ 1
        acc = acc + (bit << jnp.uint32(sh))
    return acc


@jax.jit
def hdist_lr32(a: jax.Array, b: jax.Array) -> jax.Array:
    """Hamming distance between lr residuals (ref: src/common.hpp:169-175)."""
    z = jnp.bitwise_xor(a, b)
    folded = jnp.bitwise_and(jnp.bitwise_or(z, z >> 16), jnp.uint32(0xFFFF))
    return jax.lax.population_count(folded).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("m", "r", "frac"))
def row_to_local(rix: jax.Array, m: int, r: int, frac: bool):
    """Global LSH row -> (resident mask, local row in a partial table).

    Mirrors the keep rule LSH(x) mod m (<=|==) r and the offset arithmetic
    rix/m*(r+1)+rix%m (ref: src/rqseq.cpp:125-139, src/index.cpp:160-168).
    """
    res = rix % jnp.uint32(m)
    if frac:
        resident = res <= jnp.uint32(r)
        local = (rix // jnp.uint32(m)) * jnp.uint32(r + 1) + res
    else:
        resident = res == jnp.uint32(r)
        local = rix // jnp.uint32(m)
    return resident, local


@functools.partial(jax.jit, static_argnames=("k",))
def bp64_pair(codes: jax.Array, k: int):
    """2-bit packed k-mer encoding as a (hi, lo) uint32 pair per window.

    bp64 = sum_j base(bit-position j) << 2j (ref: src/common.hpp:225-243);
    bit-position j corresponds to offset k-1-j in the window. Only needed on
    the index-build path (minimizer hashing); kept as 32-bit lanes (see
    core/u64.py).
    """
    lo_js = [j for j in range(k) if j < 16]
    hi_js = [j for j in range(k) if j >= 16]
    lo = _padded_window_sum_bits2(codes, [k - 1 - j for j in lo_js],
                                  [2 * j for j in lo_js], k)
    if hi_js:
        hi = _padded_window_sum_bits2(codes, [k - 1 - j for j in hi_js],
                                      [2 * j - 32 for j in hi_js], k)
    else:
        hi = jnp.zeros_like(lo)
    return hi, lo


def _padded_window_sum_bits2(codes, offs, shifts, k):
    L = codes.shape[-1]
    P = L - k + 1
    acc = jnp.zeros(codes.shape[:-1] + (P,), jnp.uint32)
    c = codes.astype(jnp.uint32)
    for off, sh in zip(offs, shifts):
        acc = acc + (c[..., off: off + P] << jnp.uint32(sh))
    return acc
