"""Device-mesh construction and sharding helpers.

The reference has no parallelism of its own (SURVEY.md section 2.4): its
concurrency is GR's thread-per-block scheduler. Here the two first-class
axes are:

- ``ch``  (channel / data parallel): independent RX/TX channels sharded over
  chips with no cross-channel communication (BASELINE config 3: "64
  independent flexframe channels").
- ``time`` (sequence parallel): one contiguous sample stream split into
  time blocks across chips, with overlap-save halo exchange of boundary
  samples via ppermute (BASELINE config 5; parallel/halo.py) — the SDR
  analog of ring attention's neighbor ring.

Multi-host initialization uses jax.distributed (gRPC bootstrap); a single
process sees its local mesh slice the usual way.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TIME_AXIS = "time"
CH_AXIS = "ch"


def make_mesh(
    n_time: int | None = None,
    n_ch: int | None = None,
    devices: list | None = None,
) -> Mesh:
    """Build a (time, ch) mesh over the available devices.

    Defaults: all devices on the time axis (n_ch=1). The mesh follows the
    algorithm alone: the cards of a host are joined all to all.
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_time is None and n_ch is None:
        n_time, n_ch = n, 1
    elif n_time is None:
        n_time = n // n_ch
    elif n_ch is None:
        n_ch = n // n_time
    if n_time * n_ch != n:
        devices = devices[: n_time * n_ch]
    grid = np.asarray(devices).reshape(n_time, n_ch)
    return Mesh(grid, (TIME_AXIS, CH_AXIS))


def channel_sharding(mesh: Mesh) -> NamedSharding:
    """[B, T] arrays: shard channels over ``ch``, time over ``time``."""
    return NamedSharding(mesh, P(CH_AXIS, TIME_AXIS))


def time_sharding(mesh: Mesh) -> NamedSharding:
    """[B, T] arrays: replicate channels, shard time blocks over ``time``."""
    return NamedSharding(mesh, P(None, TIME_AXIS))


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None):
    """Multi-host bootstrap (jax.distributed.initialize wrapper); no-op when
    already initialized or single-process."""
    if num_processes in (None, 1):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
