"""Stage-2 lane-cap truncation and the overflow fallback chain.

Real test worlds sit under the 4096-lane floor, so the truncation /
escalation paths never fire in ordinary runs; _lane_cap_override forces
them. The contract: capped runs either match the exact results or raise
the overflow flag, and the driver fallback always recovers exact values."""

import numpy as np
import pytest

from krepp_tpu.index.index import DeviceIndex
from krepp_tpu.query.engine import QueryEngine
from krepp_tpu.testing import build_world_index, sample_read_codes


@pytest.fixture(scope="module")
def dense_world():
    # near-identical genomes: every read matches every leaf, so lanes per
    # batch = B * S >> tiny caps
    built, genomes, _tree = build_world_index(seed=41, nleaves=10,
                                              glen=1500, rate=0.002)
    di = DeviceIndex.from_built(built)
    rng = np.random.default_rng(42)
    codes = sample_read_codes(rng, genomes, 8, rlen=150, mut=0.02)
    lengths = np.full(8, 150, np.int32)
    return di, codes, lengths


def test_lane_cap_truncation_fallback(dense_world):
    di, codes, lengths = dense_world
    ref = QueryEngine(di, 4).run_leaf_stage(codes, lengths)
    assert int(ref.present.sum()) > 64  # the world is match-dense

    eng = QueryEngine(di, 4)
    eng._lane_cap_override = 1  # tier 0 cap = 1 lane -> must overflow
    out = eng.run_leaf_stage_async(codes, lengths,
                                   np.ones(eng.S, bool))
    import jax

    fetched = jax.device_get(tuple(out))
    assert int(np.max(np.asarray(fetched[-1]))) & 2  # lane bit raised
    # driver-level fetch recovers exact results through the fallback
    lr = eng.fetch_prefetched(fetched, lengths, codes=codes)
    assert np.array_equal(lr.present, ref.present)
    assert np.allclose(lr.d[ref.present], ref.d[ref.present],
                       rtol=1e-12, atol=0)
    assert np.array_equal(lr.closest_slot, ref.closest_slot)


def test_event_mode_lane_exact_fallback(dense_world, monkeypatch):
    """Event mode: when probe tiers fit but lanes overflow every tier, the
    uncapped-lane re-run recovers exact results instead of hard-failing."""
    di, codes, lengths = dense_world
    ref = QueryEngine(di, 4).run_leaf_stage(codes, lengths)

    monkeypatch.setenv("KREPP_EVENT_PROBE", "1")
    eng = QueryEngine(di, 4)
    assert eng.mode == "event"
    eng._lane_cap_override = 1  # caps 1/16/256/4096... per tier; B*S=80
    # B*S = 80 > 1 and > 16 -> tiers 0,1 overflow on the lane bit; the
    # escalation chain must terminate with exact results, not RuntimeError
    lr = eng.run_leaf_stage(codes, lengths)
    assert np.array_equal(lr.present, ref.present)
    assert np.allclose(lr.d[ref.present], ref.d[ref.present],
                       rtol=1e-12, atol=0)


@pytest.fixture(scope="module")
def deep_world():
    """Diverged genomes + a small row space (h=7) -> lambda ~2.4: the same
    deep-bucket regime as the 36.6M-k-mer k=29 h=13 production world."""
    built, genomes, _tree = build_world_index(seed=43, nleaves=8,
                                              glen=15000, rate=0.2,
                                              k=21, h=7, w=25)
    di = DeviceIndex.from_built(built)
    rng = np.random.default_rng(44)
    codes = sample_read_codes(rng, genomes, 64, rlen=150, mut=0.05)
    lengths = np.full(64, 150, np.int32)
    return di, codes, lengths


def test_heavy_cap_is_stats_driven(deep_world):
    """The heavy-tail cap is sized from the index's own bucket-depth
    histogram, so a normal batch on a deep-bucket world (h=13-default-like
    statistics: load factor > 1, most entries in buckets deeper than the
    dense slots) never triggers an overflow-driven rescan (the blind
    Np//HEAVY_DIV cap once regressed the reference-default world 8.5x)."""
    import jax

    di, codes, lengths = deep_world
    eng = QueryEngine(di, 4)
    assert eng.mode == "hybrid"
    counts = np.diff(di.row_start)
    entry_frac = counts[counts > 2].sum() / counts.sum()
    assert entry_frac > 0.5  # entries overwhelmingly sit in deep buckets
    assert eng._heavy_frac >= 0.35 * 0.5 * entry_frac  # covers exact probes
    out = eng.run_leaf_stage_async(codes, lengths, np.ones(eng.S, bool))
    flags = int(np.max(np.asarray(jax.device_get(out[-1]))))
    assert flags & 1 == 0, "stats-driven cap overflowed on a normal batch"


def test_hybrid_tier_escalation_recovers_exact(deep_world):
    """Hybrid probe overflow escalates through 4x-cap tiers (and, only at
    exhaustion, the exact rescan) and always recovers exact results."""
    import jax

    di, codes, lengths = deep_world
    ref = QueryEngine(di, 4).run_leaf_stage(codes, lengths)

    eng = QueryEngine(di, 4)
    eng._heavy_cap_override = 1  # tier-0 heavy cap = 1 lane -> overflows
    out = eng.run_leaf_stage_async(codes, lengths, np.ones(eng.S, bool))
    fetched = jax.device_get(tuple(out))
    assert int(np.max(np.asarray(fetched[-1]))) & 1  # probe bit raised
    lr = eng.fetch_prefetched(fetched, lengths, codes=codes)
    assert np.array_equal(lr.present, ref.present)
    assert np.allclose(lr.d[ref.present], ref.d[ref.present],
                       rtol=1e-12, atol=0)
    assert np.array_equal(lr.closest_slot, ref.closest_slot)


def test_event_mode_dist_compact_fetch(dense_world, monkeypatch):
    """Same chain through the compact 'dist' out_mode the driver uses."""
    di, codes, lengths = dense_world
    ref = QueryEngine(di, 4).run_leaf_stage(codes, lengths)
    monkeypatch.setenv("KREPP_EVENT_PROBE", "1")
    eng = QueryEngine(di, 4)
    eng._lane_cap_override = 1
    out = eng.run_leaf_stage_async(codes, lengths, np.ones(eng.S, bool),
                                   out_mode="dist")
    lr = eng.fetch_leaf_stage(out, lengths, codes=codes, out_mode="dist")
    assert np.array_equal(lr.present, ref.present)
    assert np.allclose(lr.d[ref.present], ref.d[ref.present],
                       rtol=1e-12, atol=0)
