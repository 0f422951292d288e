"""SDUST parity vs the reference's vendored sdust.h, compiled at test time.

The reference binary itself cannot be built in this image (CLI11/boost
submodules are stripped), but sdust.h is self-contained C (kvec/kdq/kalloc
only, all present) — so the masker gets a true compiled oracle. Covers the
corners: N-breaks, window-exit flush order, the
triplet-overflow (cv*10 > 2T) suffix shrink, homopolymers, tandem repeats.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

from krepp_tpu.core.sdust import sdust

REF_SRC = "/root/reference/src"

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(REF_SRC, "sdust.h")),
    reason="reference sdust.h not mounted")

_DRIVER = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include "sdust.h"

int main(int argc, char **argv) {
    int T = atoi(argv[1]), W = atoi(argv[2]);
    static char seq[1 << 20];
    int len = 0, c;
    while ((c = getchar()) != EOF) {
        if (c == '\n' || c == '\r') continue;
        seq[len++] = (char)c;
    }
    int n = 0;
    uint64_t *r = sdust(0, (uint8_t *)seq, len, T, W, &n);
    for (int i = 0; i < n; i++)
        printf("%d\t%d\n", (int)(r[i] >> 32), (int)(uint32_t)r[i]);
    free(r);
    return 0;
}
"""


@pytest.fixture(scope="module")
def oracle_bin(tmp_path_factory):
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("no C compiler")
    d = tmp_path_factory.mktemp("sdust_oracle")
    src = d / "driver.c"
    src.write_text(_DRIVER)
    exe = d / "sdust_oracle"
    r = subprocess.run([cc, "-O2", f"-I{REF_SRC}", str(src), "-o", str(exe)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        pytest.skip(f"oracle compile failed: {r.stderr[:400]}")
    return str(exe)


def run_oracle(exe, seq: str, T: int, W: int):
    out = subprocess.run([exe, str(T), str(W)], input=seq,
                         capture_output=True, text=True, check=True)
    return [tuple(int(x) for x in line.split("\t"))
            for line in out.stdout.splitlines() if line]


CODE = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 4}


def run_ours(seq: str, T: int, W: int):
    codes = np.array([CODE[c] for c in seq], np.uint8)
    return [tuple(iv) for iv in sdust(codes, T, W)]


def check(exe, seq, T=20, W=64):
    assert run_ours(seq, T, W) == run_oracle(exe, seq, T, W), (T, W, seq)


def test_homopolymers_and_overflow(oracle_bin):
    # long runs drive cv[t]*10 > 2T -> the suffix shrink loop
    for n in (5, 12, 63, 64, 65, 200, 1000):
        check(oracle_bin, "A" * n)
        check(oracle_bin, "A" * n + "CGT" * 4 + "A" * n)
    check(oracle_bin, "A" * 500, T=20, W=12)
    check(oracle_bin, "A" * 500, T=5, W=8)


def test_tandem_repeats(oracle_bin):
    rng = np.random.default_rng(1)
    bases = "ACGT"
    for ulen in (2, 3, 4, 7, 11):
        unit = "".join(bases[i] for i in rng.integers(0, 4, ulen))
        seq = unit * (300 // ulen)
        check(oracle_bin, seq)
        check(oracle_bin, seq, T=30, W=32)


def test_n_breaks(oracle_bin):
    rng = np.random.default_rng(2)
    bases = np.array(list("ACGT"))
    for trial in range(20):
        n = int(rng.integers(30, 400))
        s = list(bases[rng.integers(0, 4, n)])
        # embed a low-complexity patch and sprinkle N runs
        p = int(rng.integers(0, max(1, n - 20)))
        s[p: p + 18] = list("ATATATATATATATATAT")
        for _ in range(int(rng.integers(0, 5))):
            q = int(rng.integers(0, n))
            run = int(rng.integers(1, 6))
            s[q: q + run] = ["N"] * run
        check(oracle_bin, "".join(s[:n]))


def test_window_exit_flush(oracle_bin):
    """Sequences ending right inside active windows (the end-of-input
    flush path), across window sizes."""
    rng = np.random.default_rng(3)
    base = "ACACACACACACACAC" + "GGGGGGGGGGGG" + "TATATATATATATATA"
    for end in range(8, len(base) + 1):
        check(oracle_bin, base[:end], T=15, W=16)
    for W in (8, 12, 20, 64, 100):
        check(oracle_bin, base, T=15, W=W)


def test_randomized_agreement(oracle_bin):
    rng = np.random.default_rng(4)
    bases = np.array(list("ACGTN"))
    for trial in range(40):
        n = int(rng.integers(10, 600))
        # biased composition makes masked regions common
        probs = rng.dirichlet([1, 1, 1, 1, 0.15])
        s = "".join(bases[rng.choice(5, size=n, p=probs)])
        T = int(rng.choice([10, 20, 30]))
        W = int(rng.choice([8, 16, 64, 128]))
        check(oracle_bin, s, T=T, W=W)
