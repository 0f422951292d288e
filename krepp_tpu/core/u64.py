"""64-bit integer arithmetic emulated on uint32 pairs.

The only 64-bit quantities in the framework (the minimizer hash xur64 of the 2-bit packed k-mer, ref:
src/common.hpp:147-155, and HyperLogLog inputs) are carried as (hi, lo)
uint32 pairs and manipulated with 16-bit-limb multiplication. The design
once targeted a chip without 64-bit integer units; on GPUs and CPUs native
uint64 would do, and this module is off the query path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_U32 = jnp.uint32
_MASK16 = jnp.uint32(0xFFFF)


def mul32_hilo(a: jax.Array, b: jax.Array):
    """Full 32x32 -> 64 product as (hi, lo) uint32, via 16-bit limbs."""
    a = a.astype(_U32)
    b = b.astype(_U32)
    al, ah = a & _MASK16, a >> 16
    bl, bh = b & _MASK16, b >> 16
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    t = (ll >> 16) + (lh & _MASK16) + (hl & _MASK16)
    lo = (ll & _MASK16) | ((t & _MASK16) << 16)
    hi = hh + (lh >> 16) + (hl >> 16) + (t >> 16)
    return hi, lo


def mul64(a_hi, a_lo, b_hi, b_lo):
    """(a * b) mod 2^64 on uint32 pairs."""
    p_hi, p_lo = mul32_hilo(a_lo, b_lo)
    hi = p_hi + a_lo.astype(_U32) * b_hi + a_hi * b_lo.astype(_U32)
    return hi, p_lo


def xor64(a_hi, a_lo, b_hi, b_lo):
    return a_hi ^ b_hi, a_lo ^ b_lo


# xur64 (murmur3 finaliser) constants (ref: src/common.hpp:147-155)
_C1_HI, _C1_LO = jnp.uint32(0xFF51AFD7), jnp.uint32(0xED558CCD)
_C2_HI, _C2_LO = jnp.uint32(0xC4CEB9FE), jnp.uint32(0x1A85EC53)


@jax.jit
def xur64(hi: jax.Array, lo: jax.Array):
    """xur64_hash on (hi, lo) uint32 pairs (ref: src/common.hpp:147-155)."""
    hi = hi.astype(_U32)
    lo = lo.astype(_U32)
    lo = lo ^ (hi >> 1)                       # h ^= h >> 33
    hi, lo = mul64(hi, lo, _C1_HI, _C1_LO)    # h *= 0xff51afd7ed558ccd
    lo = lo ^ (hi >> 1)
    hi, lo = mul64(hi, lo, _C2_HI, _C2_LO)    # h *= 0xc4ceb9fe1a85ec53
    lo = lo ^ (hi >> 1)
    return hi, lo


def less64(a_hi, a_lo, b_hi, b_lo):
    """(a < b) for uint32 pairs."""
    return jnp.where(a_hi == b_hi, a_lo < b_lo, a_hi < b_hi)


def to_numpy_u64(hi, lo):
    import numpy as np

    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(
        lo, dtype=np.uint64)
