"""Device-mesh construction for whole-index search.

Counterpart of `elasticsearch_tpu/parallel/mesh.py` (the JAX package).
An index is split into primary shards and every search fans out to one
copy of each shard. The serving mesh collapses that fan-out into one
program over a stack of every (shard, segment) entry: the entries are
laid out along a ``shards`` axis and a query batch along a ``data``
axis.

The reference hands the grid to `jax.sharding.Mesh` and lets
`shard_map` place one fold of the stack per device. Here a `Mesh` is a
small record of the same grid (a numpy array of `torch.device`s) and the
axis names. The port's mesh spans exactly one device, the index's own:
its ``shards`` axis is 1 wide, so the whole stack folds onto it
(``fold = E``, the number of entries) and every per-entry step is a
batched tensor operation over the entry axis. Spreading the stack over
several cards is ROADMAP item 12c.

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


def mesh_device(mesh: Mesh) -> torch.device:
    """The one device a mesh's program runs on. A grid of several
    distinct devices is the multi-card mesh (ROADMAP item 12c), which
    the port does not have: it raises instead of quietly running the
    stack on one of them."""
    devs = {str(d) for d in mesh.devices.ravel()}
    if len(devs) != 1:
        raise ValueError(
            f"the mesh spans {len(devs)} devices; the port runs a mesh on "
            "one device (several cards are ROADMAP queue 1 item 12c)"
        )
    return mesh.devices.ravel()[0]
