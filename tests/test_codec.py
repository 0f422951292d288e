"""Codec layer vs the pure-Python oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from krepp_tpu.params import LSHParams
from krepp_tpu.core import codec, u64

import oracle


def random_lsh(k=27, h=11, m=4, seed=3):
    return LSHParams.generate(k, h, m, seed=seed)


def random_seq(rng, n, with_n=False):
    alpha = "ACGTN" if with_n else "ACGT"
    p = [0.235, 0.235, 0.235, 0.235, 0.06] if with_n else None
    return "".join(rng.choice(list(alpha), size=n, p=p))


@pytest.mark.parametrize("k,h", [(27, 11), (29, 13), (19, 3), (31, 15), (20, 4)])
def test_hash_and_residual_match_oracle(k, h):
    rng = np.random.default_rng(11)
    lsh = LSHParams.generate(k, h, 4, seed=5)
    seq = random_seq(rng, 300)
    codes = codec.seq_to_codes(seq)
    c = jnp.asarray(codes)
    hash_or = np.asarray(codec.lsh_hash_or(c, lsh))
    hash_rc = np.asarray(codec.lsh_hash_rc(c, lsh))
    res_or = np.asarray(codec.residual_or(c, lsh))
    res_rc = np.asarray(codec.residual_rc(c, lsh))
    ppos, npos = list(lsh.ppos), list(lsh.npos)
    for t in range(0, len(seq) - k + 1, 7):
        kmer = seq[t: t + k]
        enc_lr, enc_bp = oracle.compute_encoding(kmer)
        assert hash_or[t] == oracle.compute_hash(enc_bp, ppos)
        assert res_or[t] == oracle.drop_ppos_lr(enc_lr, npos, k, h)
        rcbp = oracle.revcomp_bp64(enc_bp, k)
        assert hash_rc[t] == oracle.compute_hash(rcbp, ppos)
        assert res_rc[t] == oracle.drop_ppos_lr(oracle.conv_bp64_lr64(rcbp), npos, k, h)


def test_window_valid():
    codes = codec.seq_to_codes("ACGTNACGTACGTACGTACGT")
    v = np.asarray(codec.window_valid(jnp.asarray(codes), 5))
    # windows 0..16; windows overlapping index 4 (N) invalid
    expect = np.array([all(codes[t: t + 5] < 4) for t in range(17)])
    assert (v == expect).all()


def test_hdist_lr32():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, size=100, dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, size=100, dtype=np.uint32)
    got = np.asarray(codec.hdist_lr32(jnp.asarray(a), jnp.asarray(b)))
    for i in range(100):
        assert got[i] == oracle.hdist_lr32(int(a[i]), int(b[i]))


def test_bp64_and_xur64():
    rng = np.random.default_rng(1)
    k = 27
    seq = random_seq(rng, 200)
    codes = jnp.asarray(codec.seq_to_codes(seq))
    hi, lo = codec.bp64_pair(codes, k)
    zhi, zlo = u64.xur64(hi, lo)
    hi, lo, zhi, zlo = (np.asarray(x) for x in (hi, lo, zhi, zlo))
    for t in range(0, 200 - k + 1, 5):
        _, enc_bp = oracle.compute_encoding(seq[t: t + k])
        assert (int(hi[t]) << 32) | int(lo[t]) == enc_bp
        assert (int(zhi[t]) << 32) | int(zlo[t]) == oracle.xur64(enc_bp)


def test_mul64_random():
    rng = np.random.default_rng(2)
    for _ in range(50):
        a = int(rng.integers(0, 2 ** 64, dtype=np.uint64))
        b = int(rng.integers(0, 2 ** 64, dtype=np.uint64))
        hi, lo = u64.mul64(
            jnp.uint32(a >> 32), jnp.uint32(a & 0xFFFFFFFF),
            jnp.uint32(b >> 32), jnp.uint32(b & 0xFFFFFFFF))
        got = (int(hi) << 32) | int(lo)
        assert got == (a * b) % (1 << 64)


def test_row_to_local():
    rix = jnp.asarray(np.arange(100, dtype=np.uint32))
    resident, local = codec.row_to_local(rix, 4, 1, True)
    resident, local = np.asarray(resident), np.asarray(local)
    for i in range(100):
        assert resident[i] == (i % 4 <= 1)
        if resident[i]:
            assert local[i] == (i // 4) * 2 + i % 4
    resident, local = codec.row_to_local(rix, 4, 1, False)
    resident, local = np.asarray(resident), np.asarray(local)
    for i in range(100):
        assert resident[i] == (i % 4 == 1)
        if resident[i]:
            assert local[i] == i // 4


def test_pack_unpack_codes_roundtrip():
    """pack_codes_host/unpack_codes must reproduce codes exactly, with
    position >= length and interior/trailing Ns all decoding to 4."""
    rng = np.random.default_rng(5)
    for trial in range(8):
        B = int(rng.integers(1, 6))
        L = int(rng.integers(1, 200))
        lengths = rng.integers(0, L + 1, B).astype(np.int32)
        codes = np.full((B, L), 4, np.uint8)
        for b in range(B):
            codes[b, : lengths[b]] = rng.integers(0, 4, lengths[b])
            if trial % 2 == 1 and lengths[b] > 2:
                # interior + trailing Ns within the read
                codes[b, rng.integers(0, lengths[b])] = 4
                codes[b, lengths[b] - 1] = 4
        packed, vbits = codec.pack_codes_host(codes, lengths)
        if trial % 2 == 0:
            assert vbits is None
        got = np.asarray(codec.unpack_codes(
            jnp.asarray(packed), jnp.asarray(lengths), L,
            None if vbits is None else jnp.asarray(vbits)))
        want = codes.copy()
        for b in range(B):
            want[b, lengths[b]:] = 4
        assert (got == want).all()


def test_pack_bits_roundtrip():
    rng = np.random.default_rng(6)
    for S in (1, 24, 32, 33, 100):
        flags = rng.random((7, S)) < 0.3
        words = np.asarray(codec.pack_bits_device(jnp.asarray(flags)))
        assert (codec.unpack_bits_host(words, S) == flags).all()


def test_strand_hashes_conv_exact():
    """The convolution formulation must match the slice-sum hashes bit-for-bit
    on valid windows, across parameter corners (incl. h=15, k-h=16)."""
    rng = np.random.default_rng(9)
    from krepp_tpu.params import LSHParams

    for k, h in ((27, 11), (31, 15), (19, 3), (20, 4)):
        lp = LSHParams.generate(k=k, h=h, m=4, seed=1)
        codes = rng.integers(0, 4, (5, 150)).astype(np.uint8)
        codes[2, 40:43] = 4  # interior Ns
        jc = jnp.asarray(codes)
        rix_or, rix_rc, res_or, res_rc, valid = (
            np.asarray(a) for a in codec.strand_hashes_conv(jc, lp))
        v_ref = np.asarray(codec.window_valid(jc, k))
        assert (valid == v_ref).all()
        for got, ref_fn in ((rix_or, codec.lsh_hash_or),
                            (rix_rc, codec.lsh_hash_rc),
                            (res_or, codec.residual_or),
                            (res_rc, codec.residual_rc)):
            ref = np.asarray(ref_fn(jc, lp))
            assert (got[v_ref] == ref[v_ref]).all(), (k, h, ref_fn.__name__)
