"""Device-mesh construction for whole-index search.

Counterpart of `elasticsearch_tpu/parallel/mesh.py` (the JAX package).
An index is split into primary shards and every search fans out to one
copy of each shard. The serving mesh collapses that fan-out into one
program over a stack of every (shard, segment) entry: the entries are
laid out along a ``shards`` axis and a query batch along a ``data``
axis.

The reference hands the grid to `jax.sharding.Mesh` and lets
`shard_map` place one fold of the stack per device. Here a `Mesh` is a
small record of the same grid (a numpy array of `torch.device`s, one per
slot) and the axis names, and parallel/sharded.py does the placing: slot
(r, c) holds fold c of the stack (``fold_factor`` entries) on its
device, every ``data`` row r holds a full copy of the stack and takes
its share of the query rows, and a step launches each slot's part on
that slot's device before the pages come to the coordinating device
(`coord_device`, the first slot's: the index's own) for the merge.

A grid may name one device more than once: each slot still holds its
own fold. That is the port's counterpart of the reference's forced host
device count, which the CPU tests and a one-card run use; serving builds
its grid from distinct devices only (MeshExecutor._devices).

Layouts need not be square or even divisible: when there are fewer
devices than shards the ``shards`` axis is narrower and entries fold
onto devices (``fold_factor`` per device) instead of raising.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

SHARD_AXIS = "shards"
DATA_AXIS = "data"


@dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, shards) grid of devices with the reference's axis names."""

    devices: np.ndarray  # object [n_data, n_shard_devices] of torch.device
    axis_names: Tuple[str, str] = (DATA_AXIS, SHARD_AXIS)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(
    n_shards: int,
    n_data: int = 1,
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """Builds a (data, shards) mesh for ``n_shards`` shard stacks.

    The ``shards`` axis gets ``min(n_shards, len(devices) // n_data)``
    devices — non-power-of-two shard counts use exactly that many
    devices, and when fewer devices than shards are available the axis
    is simply narrower and shards fold onto devices (``fold_factor``
    per device) instead of raising. ``devices`` defaults to every
    visible CUDA device."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_shards < 1 or n_data < 1:
        raise ValueError(
            f"mesh axes must be >= 1 (data={n_data} x shards={n_shards})"
        )
    if len(devices) < n_data:
        raise ValueError(
            f"mesh needs at least {n_data} devices for the data axis, "
            f"have {len(devices)}"
        )
    g = min(n_shards, len(devices) // n_data)
    grid = np.empty((n_data, g), dtype=object)
    for i, d in enumerate(devices[: n_data * g]):
        grid[i // g, i % g] = d
    return Mesh(grid)


def fold_factor(mesh: Mesh, n_entries: int) -> int:
    """Shards (stacked entries) per device on the ``shards`` axis: the
    stacked arrays must carry ``mesh.shape[SHARD_AXIS] * fold_factor``
    rows (trailing rows padded empty) so each device holds an equal
    fold of the stack."""
    g = mesh.shape[SHARD_AXIS]
    return max(1, -(-max(n_entries, 1) // g))


def single_device_mesh(device="cuda") -> Mesh:
    return make_mesh(1, 1, devices=[torch.device(device)])


def mesh_shape(mesh: Mesh) -> Tuple[int, int]:
    return mesh.shape[DATA_AXIS], mesh.shape[SHARD_AXIS]


def coord_device(mesh: Mesh) -> torch.device:
    """The device a step merges on and returns its page from: the first
    slot's, which MeshExecutor makes the index's own device."""
    return mesh.devices[0, 0]
