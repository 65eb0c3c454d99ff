"""Explicit halo-exchange distributed SpMV (shard_map + ppermute).

SURVEY.md §7 step 7 / §2.5: the spatial analog of sequence parallelism —
each device owns a contiguous slab of rows; SpMV needs ghost entries of x
from the neighboring shards.  The GSPMD baseline (pyamg_tpu.parallel.
partition) lets the partitioner insert collectives; this module is the
*explicit* version: a shard_map kernel that

1. sends boundary slices to ring neighbors with `lax.ppermute` (NCCL on
   the GPU; XLA schedules the permutes concurrently with interior compute),
2. extends the local block with the received halos,
3. runs the rolled-DIA SpMV on the extended vector.

Ring wrap-around is harmless for the same reason plain DIA rolls are:
entries whose column leaves the matrix have zero stored data.

`ppermute` is the collective named by BASELINE.json:5 ("halo vector
exchange via jax.lax collectives").
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ..sparse import DIAMatrix

__all__ = ["make_halo_dia_spmv", "halo_width"]


def halo_width(dia: DIAMatrix):
    """Maximum ghost width needed by a DIA operator's offsets."""
    return max(max(abs(o) for o in dia.offsets), 1)


def make_halo_dia_spmv(dia: DIAMatrix, mesh, axis="x"):
    """Build a jitted distributed SpMV y = A @ x for a row-sharded DIA A.

    Returns ``(spmv, place)`` where ``place(x)`` shards a global vector
    over the mesh and ``spmv(data, x_sharded)`` computes the product with
    explicit ppermute halo exchange.  ``data`` is the DIA data array
    sharded P(None, axis) (pass ``dia.data`` after ``jax.device_put``).

    Requires n_pad divisible by the mesh size and halo <= local size.
    """
    ndev = int(np.prod([mesh.shape[a] for a in mesh.axis_names
                        if a == axis]))
    n_pad = dia.n_pad
    if n_pad % ndev != 0:
        raise ValueError(f"n_pad {n_pad} not divisible by mesh size {ndev}")
    n_local = n_pad // ndev
    halo = halo_width(dia)
    if halo > n_local:
        raise ValueError(f"halo {halo} exceeds local block {n_local}; "
                         "use fewer devices or the replicated path")
    offsets = dia.offsets

    fwd = [(i, (i + 1) % ndev) for i in range(ndev)]
    bwd = [(i, (i - 1) % ndev) for i in range(ndev)]

    def local_spmv(data_loc, x_loc):
        # data_loc: (ndiags, n_local); x_loc: (n_local,)
        # halo from the left neighbor = its trailing slice, and vice versa
        from_left = lax.ppermute(x_loc[-halo:], axis, fwd)
        from_right = lax.ppermute(x_loc[:halo], axis, bwd)
        x_ext = jnp.concatenate([from_left, x_loc, from_right])
        y = jnp.zeros_like(x_loc)
        for d, off in enumerate(offsets):
            seg = x_ext[halo + off: halo + off + n_local]   # static slice
            y = y + data_loc[d] * seg
        return y

    fn = shard_map(
        local_spmv, mesh=mesh,
        in_specs=(P(None, axis), P(axis)),
        out_specs=P(axis),
    )
    spmv = jax.jit(fn)

    def place(x):
        return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(axis)))

    return spmv, place
