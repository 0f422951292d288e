"""Sharded (multi-device) query path vs single-device, on the virtual CPU
mesh (8 devices via --xla_force_host_platform_device_count)."""

import numpy as np
import pytest
import jax

from krepp_tpu.params import IndexParams, LSHParams
from krepp_tpu.index.build import build_index
from krepp_tpu.index.index import DeviceIndex
from krepp_tpu.query.engine import QueryEngine
from krepp_tpu.parallel.mesh import ShardedQueryEngine, make_query_mesh
from krepp_tpu.tree.newick import Tree
from krepp_tpu.core.codec import seq_to_codes, pad_codes_batch

import worldgen
from test_e2e_dist import write_world


@pytest.fixture(scope="module", params=[11, 13], ids=["h11-dense", "h13-sparse"])
def world(request, tmp_path_factory):
    h = request.param
    rng = np.random.default_rng(31)
    tmp = tmp_path_factory.mktemp("sh")
    nwk, genomes = worldgen.make_world(rng, nleaves=6, glen=1500, rate=0.05)
    input_map = write_world(tmp, genomes)
    k = 27 if h == 11 else 29
    params = IndexParams(lsh=LSHParams.generate(k, h, 4, seed=6),
                         w=35, r=1, frac=True)
    tree = Tree.parse(nwk)
    built = build_index(input_map, params, tree, progress=False)
    di = DeviceIndex.from_built(built)
    # h=13 must exercise the sparse-row (binary-searched) layout — the
    # reference's default row space (ref: src/krepp.hpp:47-58)
    assert (di.row_ids is not None) == (h == 13)
    reads = worldgen.sample_reads(rng, genomes, n=11, mut=0.05)
    return di, reads


@pytest.mark.parametrize("n_data,n_shard", [(1, 8), (2, 4), (8, 1)])
def test_sharded_equals_single(world, n_data, n_shard):
    di, reads = world
    assert len(jax.devices()) >= 8, "need 8 virtual CPU devices"
    mesh = make_query_mesh(n_data, n_shard)
    codes, lengths = pad_codes_batch([seq_to_codes(s) for _, s in reads])
    e0 = QueryEngine(di, 4)
    lr0 = e0.run_leaf_stage(codes, lengths)
    e1 = ShardedQueryEngine(di, mesh, 4)
    assert e1.mode == "hybrid", "sharded engine must take the fast path"
    lr1 = e1.run_leaf_stage(codes, lengths)
    assert np.array_equal(lr0.present, lr1.present)
    assert np.array_equal(lr0.hist, lr1.hist)
    assert np.array_equal(lr0.closest_slot, lr1.closest_slot)
    # histograms merge exactly (integer psum over row-disjoint buckets);
    # the f64 Brent can differ at the last-ulp level across shardings due
    # to XLA vectorization choices — far below the 5-decimal output grid
    assert np.allclose(lr0.d[lr0.present], lr1.d[lr1.present],
                       rtol=1e-9, atol=1e-11)
    assert np.array_equal(lr0.onmers, lr1.onmers)


def test_cli_mesh_dist_and_place(world, tmp_path):
    """--mesh through the CLI on the virtual CPU mesh."""
    import json

    from krepp_tpu.cli import main
    from krepp_tpu.index import artifact
    from krepp_tpu.testing import sample_reads

    di, reads = world
    # need a disk index + query file
    idx = str(tmp_path / "idx")
    # rebuild a BuiltIndex-compatible artifact from the DeviceIndex's source
    # world: reuse the module fixture's arrays via reference export is not
    # available here, so build a fresh small index on disk
    rng = np.random.default_rng(2)
    import worldgen
    from test_e2e_dist import write_world
    from krepp_tpu.params import IndexParams, LSHParams
    from krepp_tpu.index.build import build_index
    from krepp_tpu.tree.newick import Tree
    nwk, genomes = worldgen.make_world(rng, nleaves=6, glen=1200, rate=0.05)
    im = write_world(tmp_path, genomes)
    params = IndexParams(lsh=LSHParams.generate(27, 11, 2, seed=4), w=35,
                         r=1, frac=True)
    built = build_index(im, params, Tree.parse(nwk), progress=False)
    artifact.save_native(built, idx)
    qpath = tmp_path / "q.fq"
    with open(qpath, "w") as f:
        for rid, seq in worldgen.sample_reads(rng, genomes, n=6):
            f.write(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n")
    dout = str(tmp_path / "d_mesh.tsv")
    assert main(["dist", "-q", str(qpath), "-i", idx, "-o", dout,
                 "--mesh", "2x4"]) == 0
    dout0 = str(tmp_path / "d_single.tsv")
    assert main(["dist", "-q", str(qpath), "-i", idx, "-o", dout0]) == 0
    assert open(dout).read().splitlines()[2:] == \
        open(dout0).read().splitlines()[2:]
    pout = str(tmp_path / "p_mesh.jplace")
    assert main(["place", "-q", str(qpath), "-i", idx, "-o", pout,
                 "--mesh", "1x8"]) == 0
    doc = json.loads(open(pout).read())
    assert doc["version"] == 3


def test_sharded_event_probe(world, monkeypatch):
    """Sharded event probe (many-genome path, forced) == mask-mode single
    device; per-shard histogram partials psum exactly."""
    di, reads = world
    mesh = make_query_mesh(2, 4)
    codes, lengths = pad_codes_batch([seq_to_codes(s) for _, s in reads])
    e0 = QueryEngine(di, 4)
    lr0 = e0.run_leaf_stage(codes, lengths)
    monkeypatch.setenv("KREPP_EVENT_PROBE", "1")
    e1 = ShardedQueryEngine(di, mesh, 4)
    assert e1.mode == "event"
    lr1 = e1.run_leaf_stage(codes, lengths)
    assert np.array_equal(lr0.present, lr1.present)
    assert np.array_equal(lr0.hist, lr1.hist)
    assert np.array_equal(lr0.closest_slot, lr1.closest_slot)
    assert np.allclose(lr0.d[lr0.present], lr1.d[lr1.present],
                       rtol=1e-9, atol=1e-11)


@pytest.fixture(scope="module")
def many_world(tmp_path_factory):
    """300 genomes: naturally event mode (no bitmask table)."""
    rng = np.random.default_rng(47)
    tmp_path = tmp_path_factory.mktemp("many")
    nwk, genomes = worldgen.make_world(rng, nleaves=300, glen=400,
                                       rate=0.08)
    input_map = write_world(tmp_path, genomes)
    params = IndexParams(lsh=LSHParams.generate(29, 13, 4, seed=9),
                         w=35, r=1, frac=True)
    tree = Tree.parse(nwk)
    built = build_index(input_map, params, tree, progress=False)
    di = DeviceIndex.from_built(built)
    assert di.se_mask is None, \
        "300 genomes (> 8 mask words) must skip the bitmask table"
    reads = worldgen.sample_reads(rng, genomes, n=13, rlen=120, mut=0.04)
    return di, reads


def test_sharded_event_lanes_many_genomes(many_world, monkeypatch):
    """Sharded event-LANE path at genuinely many-genome scale (S = 300,
    naturally event mode: no bitmask table) == single-device event mode,
    element for element, on a 2x4 mesh."""
    di, reads = many_world
    codes, lengths = pad_codes_batch([seq_to_codes(s) for _, s in reads])

    e0 = QueryEngine(di, 4)
    assert e0.mode == "event" and e0._event_lanes
    lr0 = e0.run_leaf_stage(codes, lengths)

    mesh = make_query_mesh(2, 4)
    e1 = ShardedQueryEngine(di, mesh, 4)
    assert e1.mode == "event" and e1._event_lanes
    lr1 = e1.run_leaf_stage(codes, lengths)
    assert np.array_equal(lr0.present, lr1.present)
    assert np.array_equal(lr0.hist, lr1.hist)
    assert np.array_equal(lr0.closest_slot, lr1.closest_slot)
    assert np.allclose(lr0.d[lr0.present], lr1.d[lr1.present],
                       rtol=1e-9, atol=1e-11)
    assert np.allclose(lr0.v[lr0.present], lr1.v[lr1.present],
                       rtol=1e-9, atol=1e-11)

    # the dense psum fallback agrees too
    monkeypatch.setenv("KREPP_SHARD_DENSE", "1")
    e2 = ShardedQueryEngine(di, mesh, 4)
    assert e2.mode == "event" and not e2._event_lanes
    lr2 = e2.run_leaf_stage(codes, lengths)
    assert np.array_equal(lr0.present, lr2.present)
    assert np.array_equal(lr0.hist, lr2.hist)


@pytest.mark.parametrize("n_data,n_shard", [(1, 4), (2, 2)])
def test_sharded_event_lanes_place(many_world, tmp_path, n_data, n_shard):
    """place through the sharded event-lane path (its lanes carry the
    global read and leaf of each lane) == the single-device jplace."""
    import io

    from krepp_tpu.query.place import PlaceConfig, run_place

    di, reads = many_world
    qpath = tmp_path / "q.fq"
    with open(qpath, "w") as f:
        for rid, seq in reads:
            f.write(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n")
    outs = []
    for factory in (None, lambda d, th: ShardedQueryEngine(
            d, make_query_mesh(n_data, n_shard), th)):
        buf = io.StringIO()
        assert run_place(di, str(qpath), buf, "inv", PlaceConfig(),
                         engine_factory=factory) == len(reads)
        outs.append(buf.getvalue())
    assert '"p" : [[' in outs[0]
    assert outs[1] == outs[0]
