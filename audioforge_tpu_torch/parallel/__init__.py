"""Multi-GPU fleet parallelism: the fleet mesh and candidate- or
stream-axis sharding for the batched calibration sweeps and the serving
engine (SURVEY §2.9: pure data parallelism over candidates and streams, no
collective inside a step)."""

from .dryrun import dryrun_multichip  # noqa: F401
from .fleet import (  # noqa: F401
    FleetMesh,
    batch_axis_of,
    fleet_mesh,
    gather_batched_tree,
    pad_candidates,
    shard_batched_tree,
)
