"""Packed-counter probe epilogue (Pallas, Triton route) against the XLA
epilogue and a numpy reference: interpret mode here, compiled on a GPU."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from krepp_tpu.query.pallas_kernels import probe_hist_packed
from krepp_tpu.testing import epilogue_planes, epilogue_reference


@pytest.mark.parametrize("th", [2, 4])
@pytest.mark.parametrize("W,S", [(1, 24), (2, 40)])
def test_packed_epilogue_interpret_matches_reference(th, W, S):
    N, P, C0 = 37, 164, 2      # N not a tile multiple, P two chunks
    res, light, ents = epilogue_planes(th * 10 + W, N, P, C0, W, S)
    hist, minall = probe_hist_packed(
        jnp.asarray(res), jnp.asarray(light), [jnp.asarray(e) for e in ents],
        th, C0, W, S, interpret=True)
    ref_h, ref_m = epilogue_reference(res, light, ents, th, C0, W, S)
    assert hist.shape == (N, S, th + 1)
    assert np.array_equal(np.asarray(hist), ref_h)
    assert np.array_equal(np.asarray(minall), ref_m)
    assert ref_h.sum() > 0 and (ref_m < 255).any()


def test_packed_epilogue_rejects_wide_counters():
    res = jnp.zeros((4, 256), jnp.uint32)
    with pytest.raises(ValueError):
        probe_hist_packed(res, res != 0, [res, res], 4, 1, 1, 8,
                          interpret=True)


def _engine_probe_pair(nleaves, mode):
    """(XLA, kernel) probe outputs of one engine on a small real index."""
    from krepp_tpu.index.index import DeviceIndex
    from krepp_tpu.query.engine import QueryEngine
    from krepp_tpu.testing import build_world_index, sample_read_codes

    built, genomes, _ = build_world_index(seed=11, nleaves=nleaves, glen=1500,
                                          m=2)
    engine = QueryEngine(DeviceIndex.from_built(built), hdist_th=4)
    assert engine.mode == "hybrid"
    rng = np.random.default_rng(12)
    codes = sample_read_codes(rng, genomes, 32, rlen=150, mut=0.08)
    codes[0, 30:34] = 4                     # Ns and a short read
    lengths = np.full(32, 150, np.int32)
    lengths[1] = 97
    args = (engine._tables, jnp.asarray(codes), jnp.asarray(lengths))
    out = []
    for kernel in (None, mode):
        engine.epilogue_kernel = kernel
        out.append(jax.device_get(tuple(jax.jit(engine._probe_impl)(*args))))
    return engine, out


@pytest.mark.parametrize("nleaves", [6, 70])
def test_probe_epilogue_matches_xla_engine(nleaves):
    """The kernel (interpret mode) reproduces the XLA probe outputs
    bit-for-bit on a real small index: one mask word embedded in the rows,
    and two words gathered through the color table."""
    engine, (ref, got) = _engine_probe_pair(nleaves, "interpret")
    assert engine.W == (nleaves + 31) // 32
    assert engine.hflavor == ("embed" if nleaves <= 64 else "se")
    for a, b in zip(ref[:5], got[:5]):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.gpu
def test_packed_epilogue_compiled_matches_reference(gpu_device):
    """The compiled Triton kernel at read width (P = 164) against numpy."""
    from krepp_tpu.testing import check_epilogue_kernel

    check_epilogue_kernel()
