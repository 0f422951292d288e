"""Hamming-distance-histogram pseudo-likelihood + batched Brent minimizer.

Reimplements, vectorized over a batch of (read x candidate) lanes in f64:

  * the negative log pseudo-likelihood of distance d given the histogram of
    k-mer Hamming distances (ref: src/hdhistllh.hpp:71-89), with the exact
    accumulation order of the reference so floating-point results track the
    C++ implementation bit-for-bit (modulo compiler fma differences);
  * boost::math::tools::brent_find_minima(f, 1e-10, 0.5, 16) as used by
    Minfo::optimize_likelihood (ref: src/query.cpp:426-433), including
    boost's initialisation at the upper bound and its float golden-ratio
    constant, as a masked fixed-point iteration (jax.lax.while_loop).

The minimizer runs where the histograms live; lanes are independent so the
batch dimension vectorizes trivially.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

F = jnp.float64

# boost uses `static const T golden = 0.3819660f;` (a float literal)
_GOLDEN = float(np.float64(np.float32(0.3819660)))
_TOL_BITS = 16
_TOLERANCE = float(np.ldexp(1.0, 1 - _TOL_BITS))
_BRENT_LO = 1e-10
_BRENT_HI = 0.5
_MAX_ITER = 200


def binom_tables(k: int, h: int, hdist_th: int) -> Tuple[np.ndarray, np.ndarray]:
    """Integer-exact binomial tables (ref: src/hdhistllh.hpp:56-68).

    binom_k[x] = C(k, x); binom_hnk[0] = 0 and for 1 <= x <= th,
    binom_hnk[x] = C(k, x) - C(k-h, x) (number of x-mutation patterns that
    touch at least one LSH position).
    """
    binom_k = np.zeros(k + 1, dtype=np.float64)
    binom_k[0] = 1
    ival = 1
    ivals = [1]
    for i in range(k):
        ival = (ival * (k - i)) // (i + 1)
        ivals.append(ival)
    binom_k[:] = np.array(ivals, dtype=np.float64)
    binom_hnk = np.zeros(hdist_th + 1, dtype=np.float64)
    vc = 1
    nh = k - h
    for i in range(1, hdist_th + 1):
        vc = (vc * (nh - i + 1)) // i
        binom_hnk[i] = ivals[i] - vc
    return binom_k, binom_hnk


def make_llh(k: int, h: int, hdist_th: int):
    """Build llh(d, hist, uc, rho) -> negative log pseudo-likelihood.

    d: [...]; hist: [..., th+1] (match counts per Hamming distance);
    uc: [...] (mismatch count); rho: [...]. All f64.

    Faithful unrolled translation of operator() (ref: src/hdhistllh.hpp:71-89)
    to preserve accumulation order.
    """
    binom_k, binom_hnk = binom_tables(k, h, hdist_th)

    def ipow(x, n: int):
        """x**n by squaring: multiplications only, the same on every
        backend (jnp.power may route through exp/log)."""
        acc = None
        base = x
        while n:
            if n & 1:
                acc = base if acc is None else acc * base
            base = base * base
            n >>= 1
        return acc if acc is not None else jnp.ones_like(x)

    def llh(d, hist, uc, rho):
        d = d.astype(F)
        powdc = ipow(1.0 - d, k)
        logdn = jnp.log(1.0 - d)
        logdp = jnp.log(d) - logdn
        logdn = logdn * float(k)
        dratio = d / (1.0 - d)
        s = jnp.zeros_like(d)
        lv_m = jnp.zeros_like(d)
        for x in range(k + 1):
            if x <= hdist_th:
                s = s - (logdn + float(x) * logdp) * hist[..., x]
                lv_m = lv_m + binom_hnk[x] * powdc
            else:
                lv_m = lv_m + powdc * binom_k[x]
            powdc = powdc * dratio
        return s - jnp.log(rho * lv_m + 1.0 - rho) * uc

    return llh


def make_llh_fast(k: int, h: int, hdist_th: int):
    """Moment-form llh for the Brent inner loop: llh(d, A, Bx, uc, rho).

    Mathematically identical to make_llh (ref: src/hdhistllh.hpp:71-89) but
    O(th) instead of O(k) per evaluation:

      * the histogram enters only through its moments A = sum_x hist[x] and
        Bx = sum_x x*hist[x]  (s = -(k*log(1-d))*A - (log d - log(1-d))*Bx),
        precomputed once per lane instead of re-read every iteration;
      * the x > th tail of lv_m uses sum_x C(k,x) d^x (1-d)^(k-x) = 1, so
        lv_m = sum_{x<=th} binom_hnk[x]*p_x + (1 - sum_{x<=th} binom_k[x]*p_x).

    Accumulation order differs from the reference by O(1e-15) relative —
    far below the 5-decimal output grid; the faithful make_llh remains the
    one used for reported likelihood values.
    """
    binom_k, binom_hnk = binom_tables(k, h, hdist_th)

    def ipow(x, n: int):
        acc = None
        base = x
        while n:
            if n & 1:
                acc = base if acc is None else acc * base
            base = base * base
            n >>= 1
        return acc if acc is not None else jnp.ones_like(x)

    def llh(d, A, Bx, uc, rho):
        d = d.astype(F)
        powdc = ipow(1.0 - d, k)
        logdn = jnp.log(1.0 - d)
        logdp = jnp.log(d) - logdn
        dratio = d / (1.0 - d)
        lv_m = jnp.zeros_like(d)
        ck = jnp.zeros_like(d)
        for x in range(hdist_th + 1):
            lv_m = lv_m + binom_hnk[x] * powdc
            ck = ck + binom_k[x] * powdc
            powdc = powdc * dratio
        lv_m = lv_m + (1.0 - ck)
        s = -(float(k) * logdn) * A - logdp * Bx
        return s - jnp.log(rho * lv_m + 1.0 - rho) * uc

    return llh


def make_llh_np(k: int, h: int, hdist_th: int):
    """Host (numpy f64) mirror of make_llh with the identical accumulation
    order — used to compute report-only quantities (e.g. the chi-square
    ratio) on the host instead of fetching them over the device link."""
    binom_k, binom_hnk = binom_tables(k, h, hdist_th)

    def ipow(x, n: int):
        acc = None
        base = x
        while n:
            if n & 1:
                acc = base.copy() if acc is None else acc * base
            base = base * base
            n >>= 1
        return acc if acc is not None else np.ones_like(x)

    def llh(d, hist, uc, rho):
        d = np.asarray(d, np.float64)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            powdc = ipow(1.0 - d, k)
            logdn = np.log(1.0 - d)
            logdp = np.log(d) - logdn
            logdn = logdn * float(k)
            dratio = d / (1.0 - d)
            s = np.zeros_like(d)
            lv_m = np.zeros_like(d)
            for x in range(k + 1):
                if x <= hdist_th:
                    s = s - (logdn + float(x) * logdp) * hist[..., x]
                    lv_m = lv_m + binom_hnk[x] * powdc
                else:
                    lv_m = lv_m + powdc * binom_k[x]
                powdc = powdc * dratio
            return s - np.log(rho * lv_m + 1.0 - rho) * uc

    return llh


def brent_find_minima(f, batch_shape, lo: float = _BRENT_LO, hi: float = _BRENT_HI,
                      max_iter: int = _MAX_ITER):
    """Batched boost-style Brent minimisation of f over [lo, hi].

    f maps an f64 array of shape `batch_shape` to f64 of the same shape.
    Returns (x_min, f_min). Masked lanes freeze once their own convergence
    criterion |x - mid| <= fract2 - (max-min)/2 holds, exactly as boost's
    loop break.
    """
    tol = _TOLERANCE
    golden = _GOLDEN

    def cond(state):
        it, done, *_ = state
        return jnp.logical_and(it < max_iter, jnp.logical_not(jnp.all(done)))

    def body(state):
        (it, done, mn, mx, x, w, v, fx, fw, fv, delta, delta2) = state
        mid = (mn + mx) * 0.5
        fract1 = tol * jnp.abs(x) + tol * 0.25
        fract2 = 2.0 * fract1
        newly_done = jnp.abs(x - mid) <= (fract2 - (mx - mn) * 0.5)
        act = jnp.logical_not(jnp.logical_or(done, newly_done))

        # --- try parabolic fit when |delta2| > fract1
        use_para = jnp.abs(delta2) > fract1
        r = (x - w) * (fx - fv)
        q = (x - v) * (fx - fw)
        p = (x - v) * q - (x - w) * r
        q = 2.0 * (q - r)
        p = jnp.where(q > 0.0, -p, p)
        q = jnp.abs(q)
        td = delta2
        golden_step = jnp.where(
            use_para,
            (jnp.abs(p) >= jnp.abs(q * td * 0.5)) | (p <= q * (mn - x)) | (p >= q * (mx - x)),
            True,
        )
        g_delta2 = jnp.where(x >= mid, mn - x, mx - x)
        g_delta = golden * g_delta2
        p_delta = p / jnp.where(q == 0.0, 1.0, q)  # guarded; unused when golden
        u_try = x + p_delta
        p_delta = jnp.where(
            ((u_try - mn) < fract2) | ((mx - u_try) < fract2),
            jnp.where((mid - x) < 0.0, -jnp.abs(fract1), jnp.abs(fract1)),
            p_delta,
        )
        new_delta2 = jnp.where(golden_step, g_delta2, jnp.where(use_para, delta, delta2))
        new_delta = jnp.where(golden_step, g_delta, p_delta)
        # note: boost sets delta2 = delta (the previous delta) only on the
        # parabolic path; on the golden path delta2 = bracket width term.

        u = jnp.where(jnp.abs(new_delta) >= fract1, x + new_delta,
                      jnp.where(new_delta > 0.0, x + jnp.abs(fract1), x - jnp.abs(fract1)))
        fu = f(u)

        improve = fu <= fx
        # bracket update
        mn2 = jnp.where(improve, jnp.where(u >= x, x, mn), jnp.where(u < x, u, mn))
        mx2 = jnp.where(improve, jnp.where(u >= x, mx, x), jnp.where(u < x, mx, u))
        # point shuffle
        v2 = jnp.where(improve, w, v)
        fv2 = jnp.where(improve, fw, fv)
        w2 = jnp.where(improve, x, w)
        fw2 = jnp.where(improve, fx, fw)
        x2 = jnp.where(improve, u, x)
        fx2 = jnp.where(improve, fu, fx)
        # non-improving shuffles
        cond_w = jnp.logical_and(jnp.logical_not(improve), (fu <= fw) | (w == x))
        v2 = jnp.where(cond_w, w, v2)
        fv2 = jnp.where(cond_w, fw, fv2)
        w2 = jnp.where(cond_w, u, w2)
        fw2 = jnp.where(cond_w, fu, fw2)
        cond_v = jnp.logical_and(
            jnp.logical_not(improve),
            jnp.logical_and(jnp.logical_not(cond_w), (fu <= fv) | (v == x) | (v == w)))
        v2 = jnp.where(cond_v, u, v2)
        fv2 = jnp.where(cond_v, fu, fv2)

        def sel(new, old):
            return jnp.where(act, new, old)

        state2 = (
            it + 1,
            jnp.logical_or(done, newly_done),
            sel(mn2, mn), sel(mx2, mx), sel(x2, x), sel(w2, w), sel(v2, v),
            sel(fx2, fx), sel(fw2, fw), sel(fv2, fv),
            sel(new_delta, delta), sel(new_delta2, delta2),
        )
        return state2

    mn0 = jnp.full(batch_shape, lo, F)
    mx0 = jnp.full(batch_shape, hi, F)
    x0 = jnp.full(batch_shape, hi, F)  # boost starts at the upper bound
    fx0 = f(x0)
    z = jnp.zeros(batch_shape, F)
    state0 = (jnp.int32(0), jnp.zeros(batch_shape, bool),
              mn0, mx0, x0, x0, x0, fx0, fx0, fx0, z, z)
    out = jax.lax.while_loop(cond, body, state0)
    (_, _, _, _, x, _, _, fx, _, _, _, _) = out
    return x, fx


def make_optimizer(k: int, h: int, hdist_th: int):
    """Returns optimize(hist[..., th+1], uc[...], rho[...]) -> (d_llh, v_llh).

    Equivalent of Minfo::optimize_likelihood (ref: src/query.cpp:426-433).
    """
    llh = make_llh(k, h, hdist_th)

    @jax.jit
    def optimize(hist, uc, rho):
        hist = hist.astype(F)
        uc = uc.astype(F)
        rho = rho.astype(F)

        def f(d):
            return llh(d, hist, uc, rho)

        return brent_find_minima(f, uc.shape)

    return optimize


def brent_on_mask(llh_fast, A, Bx, uc, rho, mask,
                  cap_divisors=(32, 8)):
    """Batched Brent restricted to mask-selected lanes (moment-form llh).

    At scale only a small fraction of (read, candidate) lanes carry matches;
    optimizing all of them wastes most of the f64 work. Lanes are
    compacted with lax.top_k into the smallest capacity tier that fits
    (N // divisor for each cap_divisor, then dense). Unselected lanes return
    d = 0.0, v = 0.0 — callers must gate on their own masks.
    """
    from .compact import compact_mask_indices

    shape = uc.shape
    N = int(np.prod(shape))
    Af = A.reshape(N)
    Bf = Bx.reshape(N)
    ucf = uc.reshape(N)
    rhof = rho.reshape(N)
    maskf = mask.reshape(N)

    caps = []
    for div in sorted(cap_divisors, reverse=True):
        kb = min(N, max(128, N // div))
        if kb < N and kb not in caps:
            caps.append(kb)

    # first-K-set lane indices via cumsum compaction (sentinel N on the
    # unfilled tail: its gathers clamp to junk that Brent churns on and the
    # write-back drops)
    Kmax = caps[-1] if caps else 0
    idx_all, nkeep = (compact_mask_indices(maskf, Kmax) if caps
                      else (None, jnp.sum(maskf.astype(jnp.int32))))

    def make_compact(Kb):
        def compact(_):
            idx = idx_all[:Kb]
            a = Af[idx]
            b = Bf[idx]
            u = ucf[idx]
            r = rhof[idx]
            d, v = brent_find_minima(lambda dd: llh_fast(dd, a, b, u, r),
                                     (Kb,))
            zero = jnp.zeros((N,), F)
            D = zero.at[idx].set(d, mode="drop")
            V = zero.at[idx].set(v, mode="drop")
            return D, V
        return compact

    def dense(_):
        d, v = brent_find_minima(
            lambda dd: llh_fast(dd, Af, Bf, ucf, rhof), (N,))
        return jnp.where(maskf, d, 0.0), jnp.where(maskf, v, 0.0)

    branches = [make_compact(kb) for kb in caps] + [dense]
    tier = jnp.searchsorted(jnp.asarray(caps, jnp.int32), nkeep)
    D, V = jax.lax.switch(tier, branches, None)
    return D.reshape(shape), V.reshape(shape)
