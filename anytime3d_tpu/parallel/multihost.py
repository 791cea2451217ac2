"""Multi-host orchestration: jax.distributed bring-up + per-host data splits.

The reference is single-host only (MirroredStrategy; SURVEY.md §2.7). Here a
multi-host run is the same program on every host: ``initialize()`` joins the
cluster, the global Mesh spans all hosts,
loaders take (process_index, process_count) shard splits (see
ModelNetLoader), and each host feeds only its addressable shard of the
batch via ``host_local_batch_slice``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Join the jax.distributed cluster (no-op for single process).

    Args default from the standard env vars (COORDINATOR_ADDRESS,
    NUM_PROCESSES, PROCESS_ID) so launchers stay thin. Returns
    (process_index, process_count)."""
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator_address:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes or int(os.environ["NUM_PROCESSES"]),
            process_id=process_id if process_id is not None else int(os.environ["PROCESS_ID"]),
        )
    return jax.process_index(), jax.process_count()


def host_local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """(start, size) of this host's slice of a globally-sized batch.

    The global batch must divide evenly; each host assembles only its slice
    and `jax.make_array_from_process_local_data` (or shard_batch on a
    host-spanning mesh) stitches the global array."""
    n = jax.process_count()
    assert global_batch % n == 0, f"global batch {global_batch} % hosts {n} != 0"
    per = global_batch // n
    return jax.process_index() * per, per


def make_global_batch(batch_local, mesh, spec=None):
    """Assemble a global sharded array from per-host local shards."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, spec if spec is not None else P("data"))
    return jax.tree_util.tree_map(
        lambda x: jax.make_array_from_process_local_data(sharding, np.asarray(x)),
        batch_local,
    )
