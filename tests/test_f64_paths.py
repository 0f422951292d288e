"""Plain-f64 data movement on every backend: the stage-2 segment reductions
and the dense stage-3 damping-weight aggregation keep full IEEE doubles
(values that differ below f32 resolution stay apart)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from krepp_tpu.query.engine import (D_MAX, _f64_segment_min,
                                    _f64_segment_select)


def _segments(seed, NB=9, per=6):
    """Sorted segment ids with two empty segments, f64 values 1e-12 apart
    (far below f32 resolution) and exact ties."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, per + 1, NB)
    sizes[[2, 5]] = 0
    seg = np.repeat(np.arange(NB, dtype=np.int32), sizes)
    K = len(seg)
    dm = 0.1 + rng.integers(0, 4, K) * 1e-12 + rng.integers(0, 3, K) * 1e-9
    keep = rng.random(K) < 0.8
    return seg, dm, keep, NB


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_f64_segment_min_matches_numpy(seed):
    seg, dm, keep, NB = _segments(seed)
    cand, at = jax.jit(_f64_segment_min, static_argnums=3)(
        jnp.asarray(dm), jnp.asarray(keep), jnp.asarray(seg), NB,
        jnp.asarray(seg))
    cand, at = np.asarray(cand), np.asarray(at)
    for b in range(NB):
        sel = (seg == b) & keep
        want = (dm[sel].min() if sel.any()
                else D_MAX if (seg == b).any() else np.inf)
        assert cand[b] == want                      # exact, not approx
        assert np.array_equal(at[seg == b], sel[seg == b] & (dm[seg == b]
                                                             == want))
    assert (cand[[2, 5]] == np.inf).all()        # segments without lanes


def test_f64_segment_select_is_exact():
    seg, dm, _keep, NB = _segments(3)
    # one marked lane per non-empty segment: its last lane
    last = np.zeros(len(seg), bool)
    ends = np.flatnonzero(np.diff(np.append(seg, NB)) != 0)
    last[ends] = True
    x = dm * np.pi                       # mantissa bits beyond f32
    got = np.asarray(jax.jit(_f64_segment_select, static_argnums=3)(
        jnp.asarray(x), jnp.asarray(last), jnp.asarray(seg), NB))
    for b in range(NB):
        sel = (seg == b) & last
        assert got[b] == (x[sel][0] if sel.any() else 0.0)


def test_dense_place_aggregation_keeps_f64():
    """PlaceAggregator._agg_impl's damping-weight einsums against numpy
    f64 within 1e-12 on weights whose mantissas do not fit f32."""
    from krepp_tpu.index.index import DeviceIndex
    from krepp_tpu.query.engine import QueryEngine
    from krepp_tpu.query.place import PlaceAggregator, PlaceConfig
    from krepp_tpu.testing import build_world_index

    built, _genomes, _tree = build_world_index(seed=5, nleaves=7, glen=1200,
                                               m=2)
    di = DeviceIndex.from_built(built)
    engine = QueryEngine(di, hdist_th=4)
    agg = PlaceAggregator(engine, di.placement_view(None), PlaceConfig())
    rng = np.random.default_rng(4)
    W = np.asarray(agg.pv.weights)
    W = np.where(W > 0, W * (1.0 + rng.random(W.shape) * 1e-9) / 3.0, 0.0)
    agg._W = jnp.asarray(W)
    B, S, X = 5, engine.S, engine.th + 1
    present = rng.random((B, S)) < 0.6
    hist = rng.integers(0, 40, (B, S, X)).astype(np.int32)
    match = hist.sum(-1).astype(np.int32)
    d = rng.random((B, S)) * 0.2
    v = rng.random((B, S))
    uc = rng.integers(0, 50, (B, S)).astype(np.float64)
    lengths = np.full(B, 150, np.int32)
    onmers = np.full(B, 124, np.int32)
    hc = rng.integers(0, 30, (B, X)).astype(np.float64)
    out = jax.jit(agg._agg_impl)(
        *(jnp.asarray(a) for a in (present, hist, match, d, v, uc, onmers,
                                   lengths, hc, hc[:, 0], hc[:, 1] / 99,
                                   hc[:, 2])))
    hist_q, uc_q = np.asarray(out[0]), np.asarray(out[1])
    p = present.astype(np.float64)
    want_h = np.einsum("qs,bsx->bqx", W, hist * p[..., None])
    want_uc = (150 - engine.lsh.k + 1) - np.einsum("qs,bs->bq", W, match * p)
    internal = ~np.asarray(agg._is_leaf_q)
    assert internal.sum() > 1
    np.testing.assert_allclose(hist_q[:, internal], want_h[:, internal],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(uc_q[:, internal], want_uc[:, internal],
                               rtol=0, atol=1e-12)
    # an f32 round trip of the weights would miss by far more than 1e-12
    lossy = np.einsum("qs,bsx->bqx", W.astype(np.float32).astype(np.float64),
                      hist * p[..., None])
    assert np.abs(lossy - want_h)[:, internal].max() > 1e-9
