"""Process bootstrap for multi-host runs. Import-light on purpose:
jax.distributed.initialize must run before ANY jax call that initialises
the XLA backend, and importing the engine modules creates device constants.

Usage (one process per host, before importing anything else from krepp_tpu):

    from krepp_tpu.parallel.boot import init_distributed
    init_distributed()          # arguments from KREPP_* env vars
    from krepp_tpu.parallel.multihost import MultiHostQueryEngine
"""

from __future__ import annotations

import os
from typing import Optional


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize with env-var defaults.

    Nothing detects a GPU or CPU cluster: set KREPP_COORDINATOR
    (host:port), KREPP_NUM_PROCESSES and KREPP_PROCESS_ID, or pass the
    arguments explicitly."""
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "KREPP_COORDINATOR")
    if num_processes is None and "KREPP_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["KREPP_NUM_PROCESSES"])
    if process_id is None and "KREPP_PROCESS_ID" in os.environ:
        process_id = int(os.environ["KREPP_PROCESS_ID"])
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
