"""Device-mesh utilities.

The reference has no distribution whatsoever (SURVEY.md §2: no pmap/pjit/
collectives).  These helpers are the greenfield device substrate: a 1-D or 2-D
`jax.sharding.Mesh` with a ``batch`` axis (MPC problem instances) and a
``time`` axis (horizon sharding for the parallel Riccati factorization).
"""
from __future__ import annotations

from typing import Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(axis_sizes: dict[str, int] | None = None, devices=None) -> Mesh:
    """Build a mesh. Default: all devices on a single ``batch`` axis.

    Example: ``make_mesh({'batch': 4, 'time': 2})`` on 8 devices.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    if axis_sizes is None:
        axis_sizes = {"batch": devices.size}
    names = tuple(axis_sizes)
    shape = tuple(axis_sizes.values())
    if int(np.prod(shape)) != devices.size:
        raise ValueError(
            f"mesh shape {axis_sizes} needs {int(np.prod(shape))} devices, "
            f"have {devices.size}"
        )
    return Mesh(devices.reshape(shape), names)


def batch_sharding(mesh: Mesh, axis: str = "batch") -> NamedSharding:
    """Sharding that splits the leading (batch) axis across ``axis``."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
