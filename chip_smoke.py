"""Smoke run of krepp-tpu on a GPU: the CLI's main path at real scale,
checked against the same commands run on the CPU.

    python chip_smoke.py [--workdir DIR]      one GPU, worlds A, B and C
    python chip_smoke.py --multi [--workdir DIR]
                                              four GPUs: the row-sharded
                                              mesh path and its comparison

Three seeded worlds (krepp_tpu.testing.make_world_codes) are written as
FASTA genomes, a Newick tree and 150 bp FASTQ reads (5% mutation, with
random no-match reads mixed in), then driven through krepp_tpu.cli.main in
this process on the GPU:

    world  genomes x length  k/h/w/m      probe path
    A      24 x 5 Mbp        29/13/35/4   hybrid, embedded masks, dense rows
    B      96 x 1 Mbp        27/11/35/4   hybrid, color-id slots, dense rows
    C      512 x 250 kbp     29/13/35/4   event probe, lane-form stage 3

`index` (host build), `inspect`, `dist` and `place` run on each world, and
`sketch` + `seek` on world A. A child process held to the CPU
(JAX_PLATFORMS=cpu) runs the same commands on the first 2,048 reads against
the same index. Integer stages must match bit for bit (hashes, bucket
routing, histograms, present bitmaps, closest slot, onmers), f64 `d` and `v`
within 1e-9, and the TSV / jplace rows exactly, except for at most 0.01% of
rows that differ by one unit in the 5th decimal.

Every phase that fails stops the run with a non-zero exit code. Only a run
in which all passed ends with the line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

WORLDS = {
    # name: (seed, genomes, genome length, k, h, w, m, reads, random reads,
    #        expected probe path (mode, flavor, sparse rows; None: either))
    "A": (101, 24, 5_000_000, 29, 13, 35, 4, 65_536, 4_096,
          ("hybrid", "embed", False)),
    "B": (202, 96, 1_000_000, 27, 11, 35, 4, 65_536, 4_096,
          ("hybrid", "se", False)),
    "C": (303, 512, 250_000, 29, 13, 35, 4, 32_768, 2_048,
          ("event", None, None)),
}
# between-genome divergence per tree level
WORLD_RATE = 0.03
READ_LEN = 150
READ_MUT = 0.05
CPU_READS = 2048
D_TOL = 1e-9            # |d|, |v| between the GPU and the CPU run
ROW_DIFF_SHARE = 1e-4   # rows allowed to differ in the 5th decimal
MULTI_READS = 16_384
BASES = np.frombuffer(b"ACGTN", np.uint8)


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """Name and power limit of the first card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- worlds
def world_paths(workdir: str, name: str) -> dict:
    d = os.path.join(workdir, name)
    return dict(dir=d, refs=os.path.join(d, "refs"),
                map=os.path.join(d, "input_map.tsv"),
                tree=os.path.join(d, "tree.nwk"),
                reads=os.path.join(d, "reads.fq"),
                sub=os.path.join(d, "reads_cpu.fq"),
                multi=os.path.join(d, "reads_multi.fq"),
                idx=os.path.join(d, "index"),
                gpu=os.path.join(d, "gpu"), cpu=os.path.join(d, "cpu"))


def _write_fastq(path: str, codes: np.ndarray, first: int = 0) -> None:
    qual = "I" * codes.shape[1]
    with open(path, "w") as f:
        for i, row in enumerate(BASES[codes]):
            f.write(f"@r{first + i}\n{row.tobytes().decode()}\n+\n{qual}\n")


def make_world(workdir: str, name: str) -> dict:
    """Write world `name`'s genomes, input map, tree and reads."""
    from krepp_tpu.testing import make_world_codes, sample_read_codes

    seed, nleaves, glen, *_, nreads, nrand, _path = WORLDS[name]
    p = world_paths(workdir, name)
    for key in ("refs", "gpu", "cpu"):
        os.makedirs(p[key], exist_ok=True)
    rng = np.random.default_rng(seed)
    nwk, genomes = make_world_codes(rng, nleaves=nleaves, glen=glen,
                                    rate=WORLD_RATE)
    with open(p["map"], "w") as fmap:
        for g in sorted(genomes):
            fa = os.path.join(p["refs"], f"{g}.fna")
            with open(fa, "wb") as f:
                f.write(f">{g}\n".encode())
                f.write(BASES[genomes[g][0]].tobytes())
                f.write(b"\n")
            fmap.write(f"{g}\t{fa}\n")
    with open(p["tree"], "w") as f:
        f.write(nwk + "\n")
    # every 17th read is random (no match): (nreads + nrand) = 17 * nrand
    reads = sample_read_codes(rng, genomes, nreads, rlen=READ_LEN,
                              mut=READ_MUT)
    junk = rng.integers(0, 4, (nrand, READ_LEN)).astype(np.uint8)
    allr = np.empty((nreads + nrand, READ_LEN), np.uint8)
    is_junk = np.arange(nreads + nrand) % 17 == 16
    allr[is_junk] = junk
    allr[~is_junk] = reads
    _write_fastq(p["reads"], allr)
    _write_fastq(p["sub"], allr[:CPU_READS])
    _write_fastq(p["multi"], allr[:MULTI_READS])
    return p


def read_codes(path: str):
    """FASTQ -> (codes [B, L] u8, lengths [B] i32) in file order."""
    from krepp_tpu.core.codec import pad_codes_batch, seq_to_codes
    from krepp_tpu.io.fastx import read_fastx

    return pad_codes_batch([seq_to_codes(s) for _n, s in read_fastx(path)],
                           pad_to=192)


# ------------------------------------------------------------ CLI phases
def cli(*argv: str) -> float:
    """One in-process CLI command; returns its wall seconds."""
    from krepp_tpu.cli import main

    t0 = time.perf_counter()
    rc = main(list(argv))
    if rc != 0:
        raise SmokeFailure(f"krepp {' '.join(argv)} returned {rc}")
    return time.perf_counter() - t0


def nkmers(index_dir: str) -> int:
    with open(os.path.join(index_dir, "meta.json")) as f:
        return int(json.load(f)["nkmers"])


def engine_state(index_dir: str, query: str) -> dict:
    """Integer and f64 stage outputs of one QueryEngine on the reads of
    `query`: hashes, bucket routing, per-(read, leaf) state."""
    import jax
    import jax.numpy as jnp

    from krepp_tpu.cli import _load_index
    from krepp_tpu.query.engine import QueryEngine

    engine = QueryEngine(_load_index(index_dir), hdist_th=4)
    codes, lengths = read_codes(query)

    @jax.jit
    def hashes(tables, codes, lengths):
        rix2, res2, valid, onmers = engine._strand_hashes(codes, lengths)
        urow, resident = engine._urow(rix2, valid[None])
        sidx, hrow, resident = engine._route_rows(tables[3] if engine.mode
                                                  != "csr" else tables[2],
                                                  urow, resident)
        return rix2, res2, valid, onmers, sidx, hrow, resident

    names = ("rix", "res", "valid", "onmers", "sidx", "hrow", "resident")
    out = dict(zip(names, jax.device_get(hashes(
        engine._tables, jnp.asarray(codes, jnp.int32),
        jnp.asarray(lengths)))))
    lr = engine.run_leaf_stage(codes, lengths)
    for f in ("present", "hist", "closest_slot", "onmers", "match", "d",
              "v", "closest_d"):
        out["lr_" + f] = np.asarray(getattr(lr, f))
    out["mode"] = np.asarray(engine.mode)
    out["flavor"] = np.asarray(str(getattr(engine, "hflavor", None)))
    out["sparse"] = np.asarray(engine.di.row_ids is not None)
    out["kernel"] = np.asarray(str(engine.epilogue_kernel))
    return out


def cpu_reference(workdir: str, name: str) -> None:
    """Child-process body: the CPU run of world `name`'s comparison set."""
    import jax

    if jax.devices()[0].platform != "cpu":
        raise SmokeFailure("the reference child must run on the CPU")
    p = world_paths(workdir, name)
    cli("dist", "-q", p["sub"], "-i", p["idx"], "-o",
        os.path.join(p["cpu"], "dist.tsv"))
    cli("place", "-q", p["sub"], "-i", p["idx"], "-o",
        os.path.join(p["cpu"], "place.jplace"))
    if os.path.exists(os.path.join(p["gpu"], "g0.sk")):
        cli("seek", "-q", p["sub"], "-i", os.path.join(p["gpu"], "g0.sk"),
            "-o", os.path.join(p["cpu"], "seek.tsv"))
    np.savez(os.path.join(p["cpu"], "engine.npz"),
             **engine_state(p["idx"], p["sub"]))


def start_cpu_reference(workdir: str, name: str) -> subprocess.Popen:
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
            f"chip_smoke.cpu_reference({workdir!r}, {name!r})")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    log_path = os.path.join(world_paths(workdir, name)["cpu"], "child.log")
    with open(log_path, "w") as lf:
        return subprocess.Popen([sys.executable, "-c", code], env=env,
                                cwd=ROOT, stdout=lf, stderr=subprocess.STDOUT)


def wait_child(proc: subprocess.Popen, workdir: str, name: str) -> None:
    rc = proc.wait()
    if rc != 0:
        with open(os.path.join(world_paths(workdir, name)["cpu"],
                               "child.log")) as f:
            tail = f.read()[-4000:]
        raise SmokeFailure(f"CPU reference for world {name} exited {rc}:\n"
                           f"{tail}")


# ------------------------------------------------------------ comparisons
_NUM = re.compile(r"-?\d+\.\d{5}|-?nan|-?inf")
_PLACEMENT = re.compile(r'\{"n" : \["([^"]+)"\].*\}')


def report_rows(path: str, names=None) -> list:
    """Result rows of a dist/seek TSV or jplace placements, without the
    header and metadata lines that carry the invocation; restricted to the
    reads in `names` when given."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if path.endswith(".jplace"):
                m = _PLACEMENT.search(line)
                if m is None:
                    continue
                line, rname = m.group(0), m.group(1)
            else:
                if line.startswith("#") or line.startswith("SEQ_ID"):
                    continue
                rname = line.split("\t", 1)[0]
            if names is None or rname in names:
                rows.append(line)
    return rows


def compare_rows(label: str, got: list, want: list) -> list:
    """Same rows, reads and edges; a row may differ only by one unit in the
    5th decimal of its numbers, in at most ROW_DIFF_SHARE of the rows.
    Returns the failures (empty when the rows agree)."""
    if len(got) != len(want):
        return [f"{label}: {len(got)} rows on the GPU, {len(want)} on the "
                "CPU"]
    ndiff, bad = 0, []
    for a, b in zip(got, want):
        if a == b:
            continue
        ndiff += 1
        na, nb = _NUM.findall(a), _NUM.findall(b)
        if (_NUM.split(a) != _NUM.split(b) or len(na) != len(nb)
                or any(x != y and not abs(float(x) - float(y)) < 1.5e-5
                       for x, y in zip(na, nb))):
            bad.append(f"  gpu {a}\n  cpu {b}")
    log(f"  {label}: {len(got)} rows, {ndiff} differ in the 5th decimal "
        f"(limit {ROW_DIFF_SHARE * len(got):.2f}), {len(bad)} by more")
    for row in bad[:3]:
        log(row)
    failures = []
    if bad:
        failures.append(f"{label}: {len(bad)} rows differ beyond one unit "
                        "in the 5th decimal")
    if ndiff > ROW_DIFF_SHARE * len(got):
        failures.append(f"{label}: {ndiff} rows differ")
    return failures




def compare_engine(label: str, got: dict, want) -> list:
    """Bit-exact integer stages; f64 d, v within D_TOL. Returns the
    failures (empty when all agree)."""
    failures = []
    # "kernel" names the epilogue, which only the GPU compiles; the probe
    # path (mode, flavor, sparse rows) must be the same
    for key in sorted(k for k in got if k != "kernel"):
        a, b = np.asarray(got[key]), np.asarray(want[key])
        if key in ("lr_d", "lr_v", "lr_closest_d"):
            finite = np.isfinite(b) & (b < 1e300)
            if not (np.array_equal(np.isfinite(a) & (a < 1e300), finite)
                    and np.array_equal(a[~finite], b[~finite])):
                failures.append(f"{label}: {key} differs off the matched "
                                "lanes")
                continue
            err = np.abs(a[finite] - b[finite])
            nbad = int((err > D_TOL).sum())
            log(f"  {label}: {key} max |gpu - cpu| = "
                f"{float(err.max(initial=0.0)):.3e} over {int(finite.sum())} "
                f"lanes, {nbad} beyond {D_TOL:g}")
            if nbad:
                failures.append(f"{label}: {key} differs beyond {D_TOL:g} "
                                f"on {nbad} lanes")
        elif a.shape != b.shape or not np.array_equal(a, b):
            n = (int((a != b).sum()) if a.shape == b.shape
                 else f"shape {a.shape} vs {b.shape}")
            log(f"  {label}: {key} differs ({n})")
            failures.append(f"{label}: {key} is not bit-exact")
    if not any("bit-exact" in f for f in failures):
        log(f"  {label}: hashes, routing, histograms, present, closest "
            "slot, onmers bit-exact")
    return failures


# ----------------------------------------------------------------- phases
def native_report() -> None:
    """Which native host libraries loaded (a missing cc or zlib shows
    here, not as a slow run)."""
    from krepp_tpu.core import native_colorize, native_extract, native_sort
    from krepp_tpu.io import native, native_report as nrep

    for label, mod, fallback in (
            ("fastx reader", native, "Python FASTA/FASTQ reader"),
            ("winnower", native_extract, "JAX winnower"),
            ("radix sort", native_sort, "numpy sort and pack"),
            ("colorizer", native_colorize, "numpy colorizer"),
            ("report writer", nrep, "Python jplace writer")):
        ok = mod.get_lib() is not None
        log(f"native {label}: {'loaded' if ok else 'MISSING, using ' + fallback}")


def device_checks() -> None:
    """The checks of the tests marked `gpu`, on this card."""
    from krepp_tpu.testing import check_epilogue_kernel

    t0 = time.perf_counter()
    check_epilogue_kernel()
    log(f"epilogue kernel (compiled) = numpy reference at P=164, W=1 and 3 "
        f"[{time.perf_counter() - t0:.1f} s]")


def run_world(workdir: str, name: str, card: str) -> subprocess.Popen:
    """GPU phases of one world; returns the CPU reference child."""
    import jax

    seed, nleaves, glen, k, h, w, m, nreads, nrand, expect = WORLDS[name]
    t0 = time.perf_counter()
    p = make_world(workdir, name)
    log(f"world {name}: {nleaves} genomes x {glen} bp, k={k} h={h} w={w} "
        f"m={m}, {nreads} + {nrand} random reads "
        f"[written in {time.perf_counter() - t0:.1f} s]")
    dt = cli("--seed", str(seed), "--num-threads", str(os.cpu_count() or 1),
             "index", "-i", p["map"], "-o", p["idx"], "-t", p["tree"],
             "-k", str(k), "-h", str(h), "-w", str(w), "-m", str(m))
    nk = nkmers(p["idx"])
    log(f"  index: {dt:.2f} s, {nk} k-mers, {nk / dt:.0f} k-mers/s "
        "(host build)")
    sk = os.path.join(p["gpu"], "g0.sk")
    if name == "A":
        dt = cli("sketch", "-i", os.path.join(p["refs"], "G000.fna"), "-o",
                 sk, "-k", "26")
        log(f"  sketch: {dt:.2f} s ({glen / dt:.0f} bp/s)")
    child = start_cpu_reference(workdir, name)
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        dt = cli("inspect", "-i", p["idx"])
    log(f"  inspect: {dt:.2f} s, {len(buf.getvalue().splitlines())} lines")
    nq = nreads + nrand
    for cmd, out in (("dist", "dist.tsv"), ("place", "place.jplace")):
        dt = cli(cmd, "-q", p["reads"], "-i", p["idx"], "-o",
                 os.path.join(p["gpu"], out))
        log(f"  {cmd}: {dt:.2f} s, {nq / dt:.0f} reads/s on {card} "
            "(compile included)")
    if name == "A":
        dt = cli("seek", "-q", p["reads"], "-i", sk, "-o",
                 os.path.join(p["gpu"], "seek.tsv"))
        log(f"  seek: {dt:.2f} s, {nq / dt:.0f} reads/s on {card}")
    t0 = time.perf_counter()
    state = engine_state(p["idx"], p["sub"])
    got = (str(state["mode"]), str(state["flavor"]),
           bool(state["sparse"]))
    want = (expect[0], str(expect[1]),
            got[2] if expect[2] is None else expect[2])
    log(f"  probe mode={got[0]} flavor={got[1]} sparse_rows={got[2]} "
        f"epilogue kernel={state['kernel']} "
        f"[{time.perf_counter() - t0:.1f} s]")
    if got != want:
        raise SmokeFailure(f"world {name} took probe path {got}, "
                           f"expected {want}")
    np.savez(os.path.join(p["gpu"], "engine.npz"), **state)
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak device memory so far: {stats.get('peak_bytes_in_use')} "
        "bytes")
    return child


def compare_world(workdir: str, name: str) -> list:
    """The GPU run of world `name` against its CPU reference; returns the
    failures."""
    p = world_paths(workdir, name)
    names = {f"r{i}" for i in range(CPU_READS)}
    with np.load(os.path.join(p["gpu"], "engine.npz")) as g, \
            np.load(os.path.join(p["cpu"], "engine.npz")) as c:
        failures = compare_engine(f"world {name} engine", dict(g), c)
    files = ["dist.tsv", "place.jplace"] + (["seek.tsv"] if name == "A"
                                            else [])
    for fn in files:
        failures += compare_rows(
            f"world {name} {fn}",
            report_rows(os.path.join(p["gpu"], fn), names),
            report_rows(os.path.join(p["cpu"], fn)))
    return failures


def run_single(workdir: str) -> None:
    card = card_line()
    log(f"card: {card}")
    native_report()
    device_checks()
    children, failures = {}, []
    try:
        for name in WORLDS:
            t0 = time.perf_counter()
            children[name] = run_world(workdir, name, card)
            log(f"world {name} GPU phases: {time.perf_counter() - t0:.1f} s")
        for name, child in list(children.items()):
            t0 = time.perf_counter()
            wait_child(child, workdir, name)
            del children[name]
            log(f"world {name} CPU reference waited "
                f"{time.perf_counter() - t0:.1f} s")
            failures += compare_world(workdir, name)
    finally:
        for child in children.values():
            child.kill()
            child.wait()
    if failures:
        raise SmokeFailure("\n  ".join(["comparisons failed:"] + failures))


def run_multi(workdir: str) -> None:
    """The row-sharded mesh path on four cards against one card."""
    import jax

    from krepp_tpu.index import artifact

    if len(jax.devices()) < 4:
        raise SmokeFailure(f"--multi needs 4 GPUs, JAX sees "
                           f"{len(jax.devices())}")
    card = card_line()
    log(f"card: {card}")
    for name in ("A", "C"):
        seed, nleaves, glen, k, h, w, m, *_ = WORLDS[name]
        p = make_world(workdir, name)
        cli("--seed", str(seed), "--num-threads", str(os.cpu_count() or 1),
            "index", "-i", p["map"], "-o", p["idx"], "-t", p["tree"],
            "-k", str(k), "-h", str(h), "-w", str(w), "-m", str(m))
        for cmd, out in (("dist", "dist.tsv"), ("place", "place.jplace")):
            base = None
            for mesh in (None, "1x4", "2x2"):
                path = os.path.join(p["gpu"], f"{mesh or '1'}-{out}")
                extra = ["--mesh", mesh] if mesh else []
                dt = cli(cmd, "-q", p["multi"], "-i", p["idx"], "-o", path,
                         *extra)
                rows = report_rows(path)
                log(f"world {name} {cmd} mesh={mesh or 'one card'}: "
                    f"{dt:.2f} s, {MULTI_READS / dt:.0f} reads/s on {card}")
                if base is None:
                    base = rows
                elif rows != base:
                    raise SmokeFailure(f"world {name} {cmd} --mesh {mesh} "
                                       "differs from one card")
            log(f"world {name} {cmd}: --mesh 1x4 and 2x2 byte-equal with "
                f"one card ({len(base)} rows)")
        if name == "A":
            idx4 = p["idx"] + "-mesh4"
            dt = cli("--seed", str(seed), "index", "--mesh", "4", "-i",
                     p["map"], "-o", idx4, "-t", p["tree"], "-k", str(k),
                     "-h", str(h), "-w", str(w), "-m", str(m))
            a, b = artifact.load_native(p["idx"]), artifact.load_native(idx4)
            same = (a.nkmers == b.nkmers and a.names == b.names
                    and all(np.array_equal(getattr(a, f), getattr(b, f))
                            for f in ("enc_v", "se_v", "inc", "rows_local"))
                    and all(np.array_equal(getattr(a.colors, f),
                                           getattr(b.colors, f))
                            for f in ("leaf_off", "leaf_list", "rho")))
            log(f"world A index --mesh 4: {dt:.2f} s, artifact "
                f"{'equal to' if same else 'DIFFERS from'} the one-device "
                "build")
            if not same:
                raise SmokeFailure("index --mesh 4 differs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default=os.path.join(ROOT, ".smoke_work"),
                    help="where worlds, indexes and outputs are written")
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card mesh path")
    args = ap.parse_args(argv)
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX runs on {devs[0].platform}",
              file=sys.stderr)
        return 2
    from krepp_tpu import configure

    configure()
    t0 = time.perf_counter()
    try:
        if args.multi:
            run_multi(args.workdir)
        else:
            run_single(args.workdir)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", flush=True)
        return 1
    log(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
