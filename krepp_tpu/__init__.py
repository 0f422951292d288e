"""krepp-tpu: k-mer LSH indexing, ML distance estimation and phylogenetic
placement on a GPU (NVIDIA H100), in JAX.

A from-scratch JAX/XLA/Pallas implementation with the capabilities of
bo1929/krepp: `index`, `dist`, `place`, `sketch`, `seek`, `inspect`.

Design (data-parallel, not a port):
  * k-mers are handled as windows of small integer base codes; LSH hashes and
    residual encodings are computed as one convolution with static integer
    weights instead of the reference's BMI2 PEXT bit tricks
    (ref: src/lshf.cpp:61-71).
  * the frozen index is a pair of dense device arrays (residuals + colors) with a
    CSR row-offset array (ref: src/table.hpp:103-146), sharded by LSH-row
    block across a device mesh.
  * the per-read match state is order-independent: a segment-min over bucket
    entries per (read, position, leaf) followed by a histogram, replacing the
    reference's sequential dedupe (ref: src/query.hpp:153-176).
  * the ML distance solver is a batched, fixed-iteration Brent minimizer in
    f64 replicating boost::math::tools::brent_find_minima semantics
    (ref: src/query.cpp:426-433).
"""

__version__ = "0.1.0"

# Version string of the reference tool whose behaviour we reproduce
# (ref: src/common.hpp:50).
REFERENCE_VERSION = "v0.8.3"


def enable_x64() -> None:
    """Enable 64-bit mode; required for the f64 likelihood path."""
    import jax

    jax.config.update("jax_enable_x64", True)


def cache_dir() -> str | None:
    """Where configure() points JAX's persistent compilation cache.

    None when JAX_COMPILATION_CACHE_DIR is set: JAX reads that variable
    itself. Otherwise a fixed directory in the checkout, so that one run
    finds what the last one compiled (the path is part of the cache key)."""
    import os

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")


def configure() -> None:
    """Standard runtime configuration: x64 + persistent compilation cache."""
    import jax

    enable_x64()
    path = cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
