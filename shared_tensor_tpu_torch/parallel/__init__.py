"""Pod tier: peer sync over the collectives of a process mesh (one rank per
(peer, shard) cell), the counterpart of ``shared_tensor_tpu.parallel``."""

from .ici import (
    Frames,
    PeerSyncState,
    add_updates,
    apply_external,
    build_sync_phases,
    build_sync_step,
    frame_ici_bytes,
    gather_replica,
    init_state,
    read_peer,
)
from .mesh import Mesh, init_multihost, make_mesh, rows_per_shard, run_mesh

__all__ = [
    "Frames",
    "Mesh",
    "PeerSyncState",
    "add_updates",
    "apply_external",
    "build_sync_phases",
    "build_sync_step",
    "frame_ici_bytes",
    "gather_replica",
    "init_multihost",
    "init_state",
    "make_mesh",
    "read_peer",
    "rows_per_shard",
    "run_mesh",
]
