"""Multi-host (multi-process) querying: the sharded engine over a global
device mesh spanning hosts.

The reference is a single OpenMP process (SURVEY §2.3); the
scale-out here runs one process per host (`jax.distributed.initialize`), shards
the index over the global `shard` axis (network between hosts, NVLink within) and
read batches over `data`. Every process executes the same SPMD program;
index arrays are materialized per-process from the host copy via
`make_array_from_callback` (only addressable shards are built locally).

Smoke-tested with two CPU processes + Gloo collectives
(tests/test_multihost.py) so the code path is tested without a cluster.
"""

from __future__ import annotations

import numpy as np

from .boot import init_distributed  # noqa: F401  (re-export)
from .mesh import ShardedQueryEngine


class MultiHostQueryEngine(ShardedQueryEngine):
    """ShardedQueryEngine over a mesh that spans processes.

    Inputs are passed as plain (identical-per-process) host arrays and
    become replicated global arrays; index shards are created through
    make_array_from_callback; fetched outputs are all-gathered so every
    process sees the full batch results (callers that want process-local
    emission can slice their own data rows instead)."""

    def _put(self, x: np.ndarray, sharding):
        import jax

        return jax.make_array_from_callback(x.shape, sharding,
                                            lambda idx: x[idx])

    def prep_input(self, x):
        return np.asarray(x)

    def fetch_out(self, dev_out):
        from jax.experimental import multihost_utils

        return multihost_utils.process_allgather(tuple(dev_out), tiled=True)

    def run_leaf_stage_async(self, codes, lengths, leaf_ok=None,
                             out_mode: str = "full"):
        from ..core import codec

        if leaf_ok is None:
            leaf_ok = np.ones(self.S, bool)
        packed, vbits = codec.pack_codes_host(np.asarray(codes),
                                              np.asarray(lengths))
        # plain numpy inputs: uncommitted, treated as replicated across the
        # global mesh (identical on every process by SPMD convention)
        return self._get_full_jit(out_mode)(
            self._tables, packed, vbits, np.asarray(lengths),
            np.asarray(leaf_ok))

    def fetch_leaf_stage(self, dev_out, lengths, codes=None, leaf_ok=None,
                         out_mode: str = "full"):
        from jax.experimental import multihost_utils

        fetched = multihost_utils.process_allgather(tuple(dev_out),
                                                    tiled=True)
        return self.fetch_prefetched(fetched, lengths, codes=codes,
                                     leaf_ok=leaf_ok, out_mode=out_mode)
