"""Multi-host bring-up.

SURVEY.md §2.5: the reference has no communication backend; the
equivalent here is `jax.distributed.initialize()` (one process per GPU
host, or per GPU) followed by a global mesh.  On GPU hosts nothing
announces the cluster, so the caller passes the coordinator address,
the process count and this process's id.  One process driving all the
cards of one host needs none of this.
"""

from __future__ import annotations

import jax

__all__ = ["initialize_distributed"]

_initialized = False


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None):
    """Initialize JAX's multi-process runtime (idempotent).

    ``coordinator_address`` (``host:port`` of process 0),
    ``num_processes`` and ``process_id`` must all be given for a
    multi-process run; with no coordinator this is a no-op (one process,
    one host).  Returns (process_index, process_count, device_count).
    """
    global _initialized
    if (not _initialized and coordinator_address is not None
            and jax.process_count() == 1):
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
        _initialized = True
    return jax.process_index(), jax.process_count(), jax.device_count()
