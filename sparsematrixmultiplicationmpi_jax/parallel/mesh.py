"""Device mesh construction — the framework's "communicator".

The reference's process model is an MPI communicator sized by ``mpirun -np``
(``scripts/mpi.sub:97``) over InfiniBand. Here it is a
``jax.sharding.Mesh`` over one host's GPUs: XLA hands the collectives to
NCCL over NVLink. Multi-host launch is not supported yet (ROADMAP).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh

__all__ = ["make_mesh", "make_mesh_2d", "AXIS"]

#: Canonical 1-D partitioning axis name used by the strategies.
AXIS = "shard"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence[jax.Device]] = None,
              axis_name: str = AXIS) -> Mesh:
    """1-D mesh over ``n_devices`` (default: all local devices).

    The reference's ``MPI_Comm_size``/``MPI_Comm_rank`` pair
    (``RowWise.cpp:17-19``) becomes mesh axis size / ``jax.lax.axis_index``.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devices)}"
            )
        devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.asarray(devices), (axis_name,))


def make_mesh_2d(n_row: int, n_col: int,
                 devices: Optional[Sequence[jax.Device]] = None,
                 axis_names=("rows", "cols")) -> Mesh:
    """2-D mesh for the combined row x k decomposition (beyond the
    reference's three 1-D schemes)."""
    if devices is None:
        devices = jax.devices()
    if n_row * n_col > len(devices):
        raise ValueError(
            f"requested {n_row}x{n_col} devices, have {len(devices)}"
        )
    import numpy as np

    arr = np.asarray(devices[: n_row * n_col]).reshape(n_row, n_col)
    return Mesh(arr, axis_names)
