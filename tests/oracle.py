"""Pure-Python oracle: a direct, slow transliteration of the reference
algorithm's *semantics* (bit-level k-mer codec, LSH, winnowing, likelihood),
used only to validate the vectorized device implementation.

Everything operates on Python ints; citations point at the reference
definitions each function mirrors.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

NT4 = {c: i for i, c in enumerate("ACGT")}
NT4.update({c.lower(): i for i, c in enumerate("ACGT")})


def code(ch: str) -> int:
    return NT4.get(ch, 4)


def compute_encoding(kmer: str) -> Tuple[int, int]:
    """(enc_lr, enc_bp) of a k-mer (ref: src/common.hpp:225-235)."""
    enc_lr = 0
    enc_bp = 0
    for ch in kmer:
        b = code(ch)
        assert b < 4
        enc_lr = (enc_lr << 1) & 0xFFFFFFFFFFFFFFFF
        enc_bp = (enc_bp << 2) & 0xFFFFFFFFFFFFFFFF
        enc_bp += b
        enc_lr += [0, 1, 1 << 32, (1 << 32) + 1][b]
    return enc_lr & 0xFFFFFFFFFFFFFFFF, enc_bp & 0xFFFFFFFFFFFFFFFF


def revcomp_bp64(x: int, k: int) -> int:
    """(ref: src/common.hpp:177-186)."""
    out = 0
    for i in range(k):
        b = (x >> (2 * i)) & 3
        out |= (3 - b) << (2 * (k - 1 - i))
    return out


def rmoddp_bp64(x: int) -> int:
    """Extract even bits (ref: src/common.hpp:188-197)."""
    out = 0
    for i in range(32):
        out |= ((x >> (2 * i)) & 1) << i
    return out


def conv_bp64_lr64(x: int) -> int:
    """(ref: src/common.hpp:223)."""
    return ((rmoddp_bp64(x >> 1) << 32) | rmoddp_bp64(x)) & 0xFFFFFFFFFFFFFFFF


def pext(x: int, mask: int) -> int:
    """Parallel bit extract (ref fallback: src/common.hpp:245-256)."""
    res = 0
    bb = 0
    while mask:
        low = mask & (-mask)
        if x & low:
            res |= 1 << bb
        bb += 1
        mask &= mask - 1
    return res


def mask_hash_bp(ppos: List[int]) -> int:
    m = 0
    for p in ppos:
        m |= 3 << (2 * p)
    return m


def mask_drop_lr(npos: List[int], k: int, h: int) -> int:
    """(ref: src/lshf.cpp:39-45): npos bits in both halves + filler bits at
    k..k+(16-(k-h))-1 in the low half."""
    m = 0
    for n in npos:
        m |= (1 << n) | (1 << (n + 32))
    for i in range(16 - (k - h)):
        m |= 1 << (i + k)
    return m


def compute_hash(enc_bp: int, ppos: List[int]) -> int:
    return pext(enc_bp, mask_hash_bp(ppos))


def drop_ppos_lr(enc_lr: int, npos: List[int], k: int, h: int) -> int:
    return pext(enc_lr, mask_drop_lr(npos, k, h))


def xur64(h: int) -> int:
    """(ref: src/common.hpp:147-155)."""
    M = 0xFFFFFFFFFFFFFFFF
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & M
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & M
    h ^= h >> 33
    return h


def hdist_lr32(x: int, y: int) -> int:
    """(ref: src/common.hpp:169-173)."""
    z = x ^ y
    return bin((z | (z >> 16)) & 0xFFFF).count("1")


def mask_bp(k: int) -> int:
    return (1 << (2 * k)) - 1


def mask_lr(k: int) -> int:
    u = (1 << 64) - 1
    return (((u >> (64 - k)) << 32) + ((u << 32) & u) >> (64 - k)) & u


def extract_mers_oracle(seq: str, k: int, w: int, ppos: List[int],
                        npos: List[int], m: int, r: int, frac: bool):
    """Transliteration of RSeq::extract_mers (ref: src/rqseq.cpp:51-144),
    sdust disabled. Returns (kept [(local_row, res)], c1_hashes, c2_hashes)
    where c1/c2 are the uint32-truncated HLL inputs."""
    h = len(ppos)
    ldiff = (w - k + 1) if w > k else 1
    w = max(w, k)
    mbp = mask_bp(k)
    mlr = 0
    u = (1 << 64) - 1
    mlr = (((u >> (64 - k)) << 32) | ((u << 32) & u) >> (64 - k)) & u
    win: List[Tuple[int, int, int]] = [(0, 0, 0)] * ldiff  # (x=bp, y=lr, z=hash)
    kix = 0
    kept = []
    c1 = []
    c2 = []
    i = 0
    l = 0
    length = len(seq)
    enc_lr = enc_bp = 0
    while i < length:
        if code(seq[i]) >= 4:
            l = 0
            i += 1
            continue
        l += 1
        i += 1
        if l < k:
            continue
        if l == k:
            enc_lr, enc_bp = compute_encoding(seq[i - k: i])
        else:
            enc_lr = (enc_lr << 1) & 0xFFFFFFFEFFFFFFFE
            enc_bp = (enc_bp << 2) & 0xFFFFFFFFFFFFFFFF
            b = code(seq[i - 1])
            enc_bp += b
            enc_lr += [0, 1, 1 << 32, (1 << 32) + 1][b]
            enc_lr &= 0xFFFFFFFFFFFFFFFF
        klix = kix % ldiff
        x = enc_bp & mbp
        y = enc_lr & mlr
        z = xur64(x)
        win[klix] = (x, y, z)
        c1.append(z & 0xFFFFFFFF)
        kix += 1
        if l < w and i != length:
            continue
        cmin = min(win, key=lambda t: t[2])
        c2.append(cmin[2] & 0xFFFFFFFF)
        rix = compute_hash(cmin[0], ppos)
        rr = rix % m
        if (rr <= r) if frac else (rr == r):
            local = rix // m * (r + 1) + rr if frac else rix // m
            kept.append((local, drop_ppos_lr(cmin[1], npos, k, h)))
    return kept, c1, c2


def search_mers_oracle(seq: str, k: int, ppos: List[int], npos: List[int]):
    """Transliteration of IBatch::search_mers k-mer enumeration
    (ref: src/query.cpp:40-94). Returns per valid k-mer:
    (or_pos, or_rix, or_res, rc_pos, rc_rix, rc_res) and onmers."""
    h = len(ppos)
    mbp = mask_bp(k)
    u = (1 << 64) - 1
    mlr = (((u >> (64 - k)) << 32) | ((u << 32) & u) >> (64 - k)) & u
    out = []
    i = 0
    l = 0
    length = len(seq)
    enc_lr = enc_bp = 0
    while i < length:
        if code(seq[i]) >= 4:
            l = 0
            i += 1
            continue
        l += 1
        i += 1
        if l < k:
            continue
        if l == k:
            enc_lr, enc_bp = compute_encoding(seq[i - k: i])
        else:
            enc_lr = (enc_lr << 1) & 0xFFFFFFFEFFFFFFFE
            enc_bp = (enc_bp << 2) & 0xFFFFFFFFFFFFFFFF
            b = code(seq[i - 1])
            enc_bp += b
            enc_lr += [0, 1, 1 << 32, (1 << 32) + 1][b]
            enc_lr &= 0xFFFFFFFFFFFFFFFF
        orbp = enc_bp & mbp
        orlr = enc_lr & mlr
        rcbp = revcomp_bp64(orbp, k)
        out.append((
            i - k,
            compute_hash(orbp, ppos), drop_ppos_lr(orlr, npos, k, h),
            length - i,
            compute_hash(rcbp, ppos), drop_ppos_lr(conv_bp64_lr64(rcbp), npos, k, h),
        ))
    return out


def llh_oracle(d: float, hist: List[float], uc: float, rho: float,
               k: int, h: int, hdist_th: int) -> float:
    """Scalar transliteration of HDistHistLLH::operator()
    (ref: src/hdhistllh.hpp:71-89)."""
    binom_k = [1] * (k + 1)
    for i in range(k):
        binom_k[i + 1] = (binom_k[i] * (k - i)) // (i + 1)
    binom_hnk = [0] * (hdist_th + 1)
    vc = 1
    nh = k - h
    for i in range(1, hdist_th + 1):
        vc = (vc * (nh - i + 1)) // i
        binom_hnk[i] = binom_k[i] - vc
    s = 0.0
    lv_m = 0.0
    powdc = (1.0 - d) ** k
    logdn = math.log(1.0 - d)
    logdp = math.log(d) - logdn
    logdn *= k
    dratio = d / (1.0 - d)
    for x in range(k + 1):
        if x <= hdist_th:
            s -= (logdn + x * logdp) * hist[x]
            lv_m += binom_hnk[x] * powdc
        else:
            lv_m += powdc * binom_k[x]
        powdc *= dratio
    return s - math.log(rho * lv_m + 1.0 - rho) * uc


def brent_oracle(f, lo: float, hi: float, bits: int = 16) -> Tuple[float, float]:
    """Scalar boost::math::tools::brent_find_minima."""
    tol = math.ldexp(1.0, 1 - bits)
    import numpy as np

    golden = float(np.float64(np.float32(0.3819660)))
    x = w = v = hi
    fw = fv = fx = f(x)
    delta = delta2 = 0.0
    mn, mx = lo, hi
    for _ in range(10000):
        mid = (mn + mx) / 2
        fract1 = tol * abs(x) + tol / 4
        fract2 = 2 * fract1
        if abs(x - mid) <= (fract2 - (mx - mn) / 2):
            break
        if abs(delta2) > fract1:
            r = (x - w) * (fx - fv)
            q = (x - v) * (fx - fw)
            p = (x - v) * q - (x - w) * r
            q = 2 * (q - r)
            if q > 0:
                p = -p
            q = abs(q)
            td = delta2
            delta2 = delta
            if (abs(p) >= abs(q * td / 2)) or (p <= q * (mn - x)) or (p >= q * (mx - x)):
                delta2 = mn - x if x >= mid else mx - x
                delta = golden * delta2
            else:
                delta = p / q
                u = x + delta
                if ((u - mn) < fract2) or ((mx - u) < fract2):
                    delta = -abs(fract1) if (mid - x) < 0 else abs(fract1)
        else:
            delta2 = mn - x if x >= mid else mx - x
            delta = golden * delta2
        if abs(delta) >= fract1:
            u = x + delta
        else:
            u = x + abs(fract1) if delta > 0 else x - abs(fract1)
        fu = f(u)
        if fu <= fx:
            if u >= x:
                mn = x
            else:
                mx = x
            v, w, x = w, x, u
            fv, fw, fx = fw, fx, fu
        else:
            if u < x:
                mn = u
            else:
                mx = u
            if (fu <= fw) or (w == x):
                v, w = w, u
                fv, fw = fw, fu
            elif (fu <= fv) or (v == x) or (v == w):
                v = u
                fv = fu
    return x, fx
