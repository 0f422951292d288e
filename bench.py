"""Benchmark: krepp-tpu throughput on one GPU.

Primary metric (one JSON line):

  {"metric": "dist_reads_per_s", "value": N, "unit": "reads/s",
   "vs_baseline": R, "extras": {...}}

vs_baseline = GPU reads/s over the same engine run in one CPU process (the
reference binary is not built here, so the CPU run of this engine is the
stand-in). The CPU baseline is measured twice and the max is taken; a
warning is printed if it falls below CPU_FLOOR, so a contended host cannot
silently inflate the speedup. Refuses to run on anything but a GPU; a
failed phase makes the exit code non-zero.

extras (each guarded by a wall-clock deadline; missing = skipped):
  build_kmers_per_s        index build throughput (host build)
  dist_big_reads_per_s     dist at reference defaults (k=29 h=13) over a
                           ~25M-k-mer (~1 GB device tables) index
  dist_1k_reads_per_s      dist over a 1000-genome index (event probe)
  place_reads_per_s        full placement pipeline reads/s
  cpu_reads_per_s          the pinned CPU baseline
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

DEADLINE_S = float(os.environ.get("KREPP_BENCH_DEADLINE", 2400))
T_START = time.time()
CPU_FLOOR = 3000.0
CARD = "cpu"   # the GPU's nvidia-smi name and power limit, set by main()

CONFIGS = {
    # name: (seed, nleaves, glen, k, h, w, m)
    "base": (7, 24, 500_000, 27, 11, 35, 4),
    "big": (11, 24, 12_500_000, 29, 13, 35, 4),
    "1k": (13, 1000, 250_000, 29, 13, 35, 4),
}


def _cache_dir(name):
    s = CONFIGS[name]
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".bench_cache", "idx-" + "-".join(str(x) for x in s))


def time_left():
    return DEADLINE_S - (time.time() - T_START)


def ensure_index(name) -> float:
    """Build the bench index in a CPU subprocess (native winnower; keeps
    build RAM out of the measured process, which owns the GPU).

    Returns build k-mers/s when the build ran now, else 0 (cached)."""
    cache = _cache_dir(name)
    stats_path = os.path.join(cache, "bench_build.json")
    if os.path.exists(os.path.join(cache, "meta.json")):
        if os.path.exists(stats_path):
            with open(stats_path) as f:
                stats = json.load(f)
            return stats["kmers"] / stats["secs"]
        return 0.0
    seed, nleaves, glen, k, h, w, m = CONFIGS[name]
    code = (
        "import os, time, json, sys\n"
        "import numpy as np\n"
        "from krepp_tpu import configure; configure()\n"
        "from krepp_tpu.testing import make_world_codes\n"
        "from krepp_tpu.params import IndexParams, LSHParams\n"
        "from krepp_tpu.index.build import build_index_from_sources\n"
        "from krepp_tpu.index import artifact\n"
        "from krepp_tpu.tree.newick import Tree\n"
        # generate the synthetic world first: only the index build itself
        # is timed (matching how the reference's README build numbers are
        # quoted over on-disk genomes)
        f"rng = np.random.default_rng({seed})\n"
        f"nwk, genomes = make_world_codes(rng, nleaves={nleaves}, "
        f"glen={glen}, rate=0.05)\n"
        "tree = Tree.parse(nwk)\n"
        f"params = IndexParams(lsh=LSHParams.generate({k}, {h}, {m}, "
        f"seed={seed}), w={w}, r=1, frac=True)\n"
        "names = sorted(genomes)\n"
        "sources = {n: (lambda n=n: iter(genomes[n])) for n in names}\n"
        "t0 = time.time()\n"
        "built = build_index_from_sources(names, sources, params, tree, "
        "progress=False, num_threads=os.cpu_count() or 1)\n"
        "dt = time.time() - t0\n"
        f"artifact.save_native(built, {cache!r})\n"
        "print(json.dumps({'kmers': built.nkmers, 'secs': dt}))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    t0 = time.time()
    out = subprocess.run([sys.executable, "-c", code], check=True, env=env,
                         capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    with open(stats_path, "w") as f:
        json.dump(stats, f)
    rate = stats["kmers"] / stats["secs"]
    print(f"[bench] index '{name}' built: {stats['kmers']} k-mers in "
          f"{stats['secs']:.1f}s = {rate:.0f} kmers/s "
          f"(total subprocess {time.time() - t0:.1f}s)", file=sys.stderr)
    return rate


def load_engine(name, hdist_th=4):
    from krepp_tpu.index import artifact
    from krepp_tpu.index.index import DeviceIndex
    from krepp_tpu.query.engine import QueryEngine

    t0 = time.time()
    built = artifact.load_native(_cache_dir(name))
    di = DeviceIndex.from_built(built)
    engine = QueryEngine(di, hdist_th=hdist_th)
    print(f"[bench] '{name}' loaded in {time.time() - t0:.1f}s "
          f"({built.nkmers} k-mers, mode={engine.mode}, S={engine.S})",
          file=sys.stderr)
    return engine


def world_reads(name, n, rlen=150, mut=0.05):
    """Sampled reads for a bench world, cached on disk (regenerating the
    big worlds costs minutes of host time per call)."""
    from krepp_tpu.testing import make_world_codes, sample_read_codes

    cache = os.path.join(os.path.dirname(_cache_dir(name)),
                         f"reads-{name}-{n}-{rlen}-{mut}.npy")
    if os.path.exists(cache):
        return np.load(cache)
    seed, nleaves, glen, *_ = CONFIGS[name]
    rng0 = np.random.default_rng(seed)
    _nwk, genomes = make_world_codes(rng0, nleaves=nleaves, glen=glen,
                                     rate=0.05)
    rng = np.random.default_rng(seed + 1)
    reads = sample_read_codes(rng, genomes, n, rlen=rlen, mut=mut)
    try:
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.save(cache, reads)
    except OSError:
        pass
    return reads


def _report_runs(label, nreads, rates):
    """best + median + spread reporting: regressions must be visible
    through run-to-run noise, with the card and its power limit beside."""
    best = max(rates)
    med = float(np.median(rates))
    spread = best / med if med else float("inf")
    print(f"[bench] {label}: {nreads} reads, best of {len(rates)} -> "
          f"{best:.0f} reads/s (median {med:.0f}, spread {spread:.2f}x) "
          f"on {CARD}", file=sys.stderr)
    if spread > 1.5:
        print(f"[bench] WARNING: {label} best/median = {spread:.2f}x > 1.5 "
              "— the host is contended; treat deltas with suspicion",
              file=sys.stderr)
    return best, med


def dist_throughput(engine, codes, batch, n_batches, label="", repeats=3):
    """Pipelined dist leaf-stage reads/s (3 batches in flight, compact
    fetch — the same path the dist driver runs).

    Repeats three times; returns (best, median). The best run approximates
    uncontended capability, the median exposes when it doesn't."""
    from collections import deque

    rlen = codes.shape[1]
    lengths = np.full(batch, rlen, np.int32)
    batches = [codes[i * batch:(i + 1) * batch]
               for i in range(n_batches + 2)]
    leaf_ok = np.ones(engine.S, bool)

    def one(b):
        return engine.fetch_leaf_stage(
            engine.run_leaf_stage_async(b, lengths, leaf_ok,
                                        out_mode="dist"),
            lengths, codes=b, leaf_ok=leaf_ok, out_mode="dist")

    lr = one(batches[0])
    lr = one(batches[1])
    print(f"[bench] {label} warmup done; present frac "
          f"{lr.present.any(axis=1).mean():.2f}", file=sys.stderr)
    rates = []
    for rep in range(repeats):
        pending = deque()
        t0 = time.time()
        for i in range(2, n_batches + 2):
            pending.append((batches[i], engine.run_leaf_stage_async(
                batches[i], lengths, leaf_ok, out_mode="dist")))
            if len(pending) >= 3:
                b, dev = pending.popleft()
                engine.fetch_leaf_stage(dev, lengths, codes=b,
                                        leaf_ok=leaf_ok, out_mode="dist")
        while pending:
            b, dev = pending.popleft()
            engine.fetch_leaf_stage(dev, lengths, codes=b, leaf_ok=leaf_ok,
                                    out_mode="dist")
        elapsed = time.time() - t0
        rates.append(batch * n_batches / elapsed)
    return _report_runs(label, batch * n_batches, rates)


def place_throughput(name, n_batches=8, batch=None, repeats=3):
    """Full place pipeline: fused device step (probe + stage2 + tree
    aggregation), pipelined fetch, host chi-square + jplace emission —
    the same work run_place does per steady-state batch, measured after
    warmup (run_place itself rebuilds its jit per call, which would time
    compilation, not placement)."""
    import io
    from collections import deque

    import jax

    from krepp_tpu.index import artifact
    from krepp_tpu.index.index import DeviceIndex
    from krepp_tpu.query.engine import QueryEngine
    from krepp_tpu.query.place import (PlaceAggregator, PlaceConfig,
                                       flush_place_batch)

    built = artifact.load_native(_cache_dir(name))
    di = DeviceIndex.from_built(built)
    engine = QueryEngine(di, hdist_th=4)
    if batch is None:
        # the production place driver's batch sizing (run_place)
        batch = min(16384, engine.suggested_batch_reads(place=True))
    pv = di.placement_view(None)
    cfg = PlaceConfig()
    agg = PlaceAggregator(engine, pv, cfg)
    codes = world_reads(name, batch * (n_batches + 1))
    lengths = np.full(batch, 150, np.int32)
    leaf_ok = np.asarray(pv.leaf_qse > 0)
    names = [f"r{i}" for i in range(batch)]
    wcount = np.zeros(pv.qflat.nnodes + 1)
    batches = [codes[i * batch:(i + 1) * batch] for i in range(n_batches + 1)]

    out = io.StringIO()

    def flush(dev):
        f = jax.device_get(tuple(dev))
        flush_place_batch(agg, f, names, lengths, pv, cfg, out, wcount,
                          False)

    flush(agg.run_place_async(batches[0], lengths, leaf_ok))  # warmup
    rates = []
    for _rep in range(repeats):
        pending = deque()
        t0 = time.time()
        for i in range(1, n_batches + 1):
            pending.append(agg.run_place_async(batches[i], lengths, leaf_ok))
            if len(pending) >= 3:
                flush(pending.popleft())
        while pending:
            flush(pending.popleft())
        rates.append(batch * n_batches / (time.time() - t0))
    print(f"[bench] place '{name}': {len(out.getvalue()) // (1 + repeats)} "
          "bytes jplace per pass", file=sys.stderr)
    return _report_runs(f"place {name}", batch * n_batches, rates)


def cpu_baseline():
    """Pinned CPU baseline: two runs, max, floor check."""
    best = 0.0
    for rep in range(2):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--cpu-baseline"],
            capture_output=True, text=True, timeout=900, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                v = json.loads(line)["cpu_reads_per_s"]
                print(f"[bench] cpu baseline run {rep}: {v:.0f} reads/s",
                      file=sys.stderr)
                best = max(best, v)
    if best and best < CPU_FLOOR:
        print(f"[bench] WARNING: cpu baseline {best:.0f} reads/s is below "
              f"the historical floor {CPU_FLOOR:.0f} — host is likely "
              "contended; speedup may be overstated", file=sys.stderr)
    return best


def main():
    if "--cpu-baseline" in sys.argv:
        import jax

        jax.config.update("jax_platforms", "cpu")
        from krepp_tpu import configure

        configure()
        ensure_index("base")
        engine = load_engine("base")
        codes = world_reads("base", 2048 * 6)
        v, _med = dist_throughput(engine, codes, 2048, 4, label="cpu",
                                  repeats=2)
        print(json.dumps({"cpu_reads_per_s": round(v, 1)}))
        return

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"[bench] needs a GPU; JAX runs on {dev.platform}",
              file=sys.stderr)
        sys.exit(2)
    global CARD
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from krepp_tpu import configure

    configure()
    extras = {}
    failed = []

    # ---- build throughput (host native path; also primes the caches)
    rate = ensure_index("base")
    if rate:
        extras["build_kmers_per_s"] = round(rate, 0)

    # ---- primary: dist on the base (h=11) world
    engine = load_engine("base")
    codes = world_reads("base", 16384 * 10)
    value, med = dist_throughput(engine, codes, 16384, 8, label="dist base")
    extras["dist_reads_per_s_median"] = round(med, 1)
    del engine

    def phase(label, need_s, fn):
        """One extra phase under the deadline; a failure is recorded and
        makes the exit code non-zero."""
        if time_left() <= need_s:
            return
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - reported, then exit 1
            import traceback

            traceback.print_exc()
            print(f"[bench] {label} failed: {e}", file=sys.stderr)
            failed.append(label)

    def big():
        r = ensure_index("big")
        if r:
            extras["build_kmers_per_s"] = round(r, 0)
        engine = load_engine("big")
        codes = world_reads("big", 16384 * 6)
        v, med = dist_throughput(engine, codes, 16384, 4,
                                 label="dist big(h13)")
        extras["dist_big_reads_per_s"] = round(v, 1)
        extras["dist_big_reads_per_s_median"] = round(med, 1)

    def dist_1k():
        ensure_index("1k")
        engine = load_engine("1k")
        b = min(8192, engine.suggested_batch_reads())
        codes = world_reads("1k", b * 6)
        v, med = dist_throughput(engine, codes, b, 4,
                                 label="dist 1k-genome")
        extras["dist_1k_reads_per_s"] = round(v, 1)
        extras["dist_1k_reads_per_s_median"] = round(med, 1)

    def place(name, key, **kw):
        def run():
            v, med = place_throughput(name, **kw)
            extras[key] = round(v, 1)
            extras[key + "_median"] = round(med, 1)
        return run

    phase("big-index dist", 600, big)
    phase("1k-genome dist", 500, dist_1k)
    phase("place", 400, place("base", "place_reads_per_s"))
    phase("1k place", 350, place("1k", "place_1k_reads_per_s",
                                 n_batches=8))

    vs_baseline = 1.0

    def baseline():
        nonlocal vs_baseline
        cpu_v = cpu_baseline()
        if cpu_v:
            extras["cpu_reads_per_s"] = round(cpu_v, 1)
            vs_baseline = value / cpu_v
            print(f"[bench] speedup vs cpu: {vs_baseline:.2f}x",
                  file=sys.stderr)

    phase("cpu baseline", 120, baseline)
    extras["card"] = CARD
    print(json.dumps({"metric": "dist_reads_per_s", "value": round(value, 1),
                      "unit": "reads/s", "vs_baseline": round(vs_baseline, 3),
                      "extras": extras}))
    if failed:
        print(f"[bench] failed phases: {', '.join(failed)}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
