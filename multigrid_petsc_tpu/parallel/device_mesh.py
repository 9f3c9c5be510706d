"""Device meshes and level-dependent sharding plans.

The replacement for the reference's domain decomposition layer
(reference: src/matbuild.c:120-144 GetRanges 1-D row partition + the three
composite ordering styles at src/matbuild.c:146-323): the grid is 2-D
block-partitioned over a jax.sharding.Mesh with axes ('y', 'x'); "ordering
styles" become sharding specs; PETSc's hidden halo exchange becomes XLA
collective-permutes inserted by GSPMD (or explicit ppermute in the
shard_map backend, parallel/halo.py).

Coarse-level agglomeration: below a per-shard size threshold the halo/
collective cost dominates any compute, so small grids are REPLICATED
(every device redundantly smooths the whole coarse grid — the same
owner-computes-everything trade the reference gets implicitly when PETSc
gives small levels mostly-empty row ranges).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _factor2(n: int) -> tuple[int, int]:
    """Most-square factorization a*b = n with a <= b."""
    a = int(np.floor(np.sqrt(n)))
    while n % a:
        a -= 1
    return a, n // a


def make_device_mesh(devices=None, shape: tuple[int, int] | None = None) -> Mesh:
    """2-D device mesh with axes ('y', 'x').

    ``shape`` defaults to the most-square factorization of the device
    count (keeps halo perimeter minimal, the analogue of picking a good
    processor grid in the reference's MPI world).
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    if shape is None:
        shape = _factor2(len(devices))
    ny, nx = shape
    if ny * nx != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    arr = np.array(devices).reshape(ny, nx)
    return Mesh(arr, ("y", "x"))


@dataclass(frozen=True)
class ShardingPlan:
    """Decides each grid's sharding: 2-D block-sharded, 1-D row-sharded,
    or replicated.

    ``min_local`` is the minimum interior points per device per dimension
    below which a grid is agglomerated (replicated on all devices).

    ``layout`` is the counterpart of the reference's ``-map`` ordering
    styles (src/matbuild.c:146-323 decided how composite unknowns were laid
    out over the MPI ranks):
      * ``"blocks"`` — 2-D block partition over the (my, mx) mesh, minimal
        halo perimeter.
      * ``"rows"`` — 1-D block-row partition over all devices (the
        reference's actual GetRanges decomposition, src/matbuild.c:120-144)
        on a (P, 1) mesh.  Build with ``row_plan()``.

    Both distribute through GSPMD sharding propagation: XLA inserts the
    halo collective-permutes (NCCL on GPUs).  Grid sides are odd (2^k - 1),
    so shards are uneven and GSPMD pads them internally.
    """

    mesh: Mesh
    min_local: int = 32
    layout: str = "blocks"

    def spec(self, ny: int, nx: int) -> P:
        my, mx = self.mesh.devices.shape
        if self.layout == "rows":
            return P("y", None) if ny // my >= self.min_local else P(None, None)
        shard_y = ny // my >= self.min_local
        shard_x = nx // mx >= self.min_local
        if shard_y and shard_x:
            return P("y", "x")
        if shard_y:
            return P("y", None)
        if shard_x:
            return P(None, "x")
        return P(None, None)

    def sharding(self, ny: int, nx: int) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(ny, nx))

    def coeff_sharding(self, ny: int, nx: int) -> NamedSharding:
        """Sharding for a (ny, 1) coefficient column: follow the grid's y
        partition, replicate across x."""
        s = self.spec(ny, nx)
        return NamedSharding(self.mesh, P(s[0] if len(s) else None, None))

    def replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, P(None, None))


def make_row_mesh(devices=None) -> Mesh:
    """(P, 1) device mesh for the 1-D row-partition layout: axis 'y' spans
    every device, axis 'x' is trivial."""
    devices = list(jax.devices()) if devices is None else list(devices)
    arr = np.array(devices).reshape(len(devices), 1)
    return Mesh(arr, ("y", "x"))


def row_plan(devices=None, min_local: int = 32) -> ShardingPlan:
    """Row-partition sharding plan (layout='rows').  See
    ShardingPlan.layout."""
    return ShardingPlan(make_row_mesh(devices), min_local=min_local,
                        layout="rows")


def put_sharded(x, sharding: NamedSharding):
    """Materialize ``x`` with ``sharding``, tolerating shard counts that do
    not divide the array (multigrid sizes are odd, 2^k - 1): GSPMD pads
    internally under jit, where plain device_put refuses uneven shards."""
    return jax.jit(
        lambda a: jax.lax.with_sharding_constraint(a, sharding)
    )(x)
