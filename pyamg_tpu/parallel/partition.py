"""Row partitioning of device hierarchies over a mesh.

Baseline distribution strategy (GSPMD; SURVEY.md §2.5 "TP analog"):

- A / P ELL rows are sharded over mesh axis 'x' (each device owns a
  contiguous block of rows == a contiguous slab of grid points);
- R rows (coarse points) are likewise sharded;
- vectors are sharded P('x'); gathers of neighbor entries in SpMV lower
  to XLA collectives automatically; Krylov dot products partition to
  psum.

The explicit halo-exchange path (shard_map + ppermute) lives in
:mod:`pyamg_tpu.parallel.dist_spmv`.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..sparse import DenseOperator, DIAMatrix, ELLMatrix

__all__ = ["make_solver_mesh", "shard_hierarchy", "shard_vector"]


def make_solver_mesh(n_devices=None, axis="x"):
    """1-D device mesh over the first n_devices devices.

    Axis type is Auto (classic GSPMD propagation): SpMV's neighbor gather
    has data-dependent cross-shard reads, which the explicit
    sharding-in-types mode refuses to resolve; under Auto the partitioner
    inserts the needed all-gather itself.  The explicit halo path
    (shard_map + ppermute) bypasses GSPMD entirely.
    """
    if n_devices is None:
        n_devices = len(jax.devices())
    return jax.make_mesh((n_devices,), (axis,),
                         axis_types=(jax.sharding.AxisType.Auto,))


def shard_vector(mesh, v, axis="x"):
    return jax.device_put(v, NamedSharding(mesh, P(axis)))


def _shard_op(mesh, E, axis="x"):
    """Row-shard a device operator (format-aware).

    DIA shards its row dimension (axis 1 of data); the rolled SpMV then
    lowers to collective-permutes of the boundary slices — halo exchange
    inserted by the partitioner.  ELL/Dense shard rows (axis 0).
    """
    if E is None:
        return None
    if isinstance(E, DIAMatrix):
        rows = NamedSharding(mesh, P(None, axis))
        return DIAMatrix(data=jax.device_put(E.data, rows),
                         offsets=E.offsets, shape=E.shape, nnz=E.nnz)
    if isinstance(E, DenseOperator):
        rows = NamedSharding(mesh, P(axis, None))
        return DenseOperator(data=jax.device_put(E.data, rows),
                             shape=E.shape, nnz=E.nnz)
    from ..sparse import TransposedWindowed, WindowedELL
    from ..sparse.composed import ComposedOperator

    ndev = mesh.devices.size
    if isinstance(E, ComposedOperator):
        # factored transfer: shard each factor independently (DIA factors
        # shard by diagonal columns, windowed factors by row block)
        return ComposedOperator(
            ops=tuple(_shard_op(mesh, op, axis) for op in E.ops),
            shape=E.shape, nnz=E.nnz)
    if isinstance(E, TransposedWindowed):
        # restriction stored as windowed(R^T): shard the base operator's
        # (fine-side) row blocks; the transpose apply reduces into the
        # replicated coarse output
        return TransposedWindowed(_shard_op(mesh, E.base, axis))
    from ..engine.unstructured_classical import (ComposedWindowed,
                                                 NeumannAIRRestriction)
    if isinstance(E, ComposedWindowed):
        # modified-classical P = M · P_direct: shard each factor's row
        # blocks independently (round 5)
        return ComposedWindowed(factors=tuple(
            _shard_op(mesh, f, axis) for f in E.factors))
    if isinstance(E, NeumannAIRRestriction):
        vec = NamedSharding(mesh, P(axis))
        return NeumannAIRRestriction(
            A=_shard_op(mesh, E.A, axis),
            Tinj=_shard_op(mesh, E.Tinj, axis),
            dinv_f=jax.device_put(E.dinv_f, vec),
            shape=E.shape, nnz=E.nnz, degree=E.degree)
    if isinstance(E, WindowedELL):
        if E.data.shape[0] % ndev != 0:
            return E  # block count not divisible: leave replicated
        rows3 = NamedSharding(mesh, P(axis, None, None))
        vec = NamedSharding(mesh, P(axis))
        return WindowedELL(
            data=jax.device_put(E.data, rows3),
            idx=jax.device_put(E.idx, rows3),
            starts=jax.device_put(E.starts, vec),
            shape=E.shape, block=E.block, w2=E.w2,
            m_chunks=E.m_chunks, nnz=E.nnz,
        )
    rows = NamedSharding(mesh, P(axis, None))
    return ELLMatrix(
        data=jax.device_put(E.data, rows),
        indices=jax.device_put(E.indices, rows),
        shape=E.shape,
        nnz=E.nnz,
    )


def _replicate(mesh, tree):
    rep = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, rep), tree)


def _level_groups(n_pad, ndev, min_local_rows):
    """Pick the number of shard groups for a level: the largest
    power-of-two divisor k of ndev keeping >= min_local_rows rows per
    shard.  k == ndev: full sharding; 1 < k < ndev: the level is
    redistributed onto k device groups (each group's shard replicated
    across the ndev/k devices within it); k == 1: fully replicated
    (agglomerated)."""
    k = 1
    cand = 2
    while cand <= ndev and ndev % cand == 0 and n_pad % cand == 0 \
            and n_pad // cand >= max(min_local_rows, 1):
        k = cand
        cand *= 2
    return k


def _submesh(mesh, k, axis):
    """Reshape the 1-D solver mesh into (k, ndev/k): rows shard over
    ``axis``, replicate over 'rep'.  Same device order as the parent
    mesh, so GSPMD composes shardings from both in one program."""
    ndev = mesh.devices.size
    if k == ndev:
        return mesh
    devs = mesh.devices.reshape(k, ndev // k)
    return Mesh(devs, (axis, "rep"),
                axis_types=(jax.sharding.AxisType.Auto,) * 2)


def shard_hierarchy(hierarchy, mesh, axis="x", min_local_rows=256):
    """Place a DeviceHierarchy's operators row-sharded on ``mesh``, with
    POWER-OF-TWO COARSE-LEVEL AGGLOMERATION (round-1 verdict item 7 /
    BASELINE.json:5): each level is sharded over the largest
    power-of-two device-group count that keeps >= ``min_local_rows``
    rows per shard.  Mid-hierarchy levels therefore land on device
    SUBSETS (shard over k groups, replicated within each group) instead
    of jumping straight from fully-sharded to fully-replicated; only
    genuinely tiny levels replicate everywhere.  The coarse dense
    inverse is replicated.

    Note: compile the hierarchy with ``row_pad = 8 * mesh_size`` so
    level paddings divide evenly.
    """
    from ..engine.hierarchy import DeviceHierarchy, DeviceLevel

    ndev = mesh.devices.size
    new_levels = []
    for lvl in hierarchy.levels:
        k = _level_groups(lvl.n_pad, ndev, min_local_rows)
        if k > 1:
            m = _submesh(mesh, k, axis)
            A = _shard_op(m, lvl.A, axis)
            Pop = _shard_op(m, lvl.P, axis)
            # R rows live on the coarse level — shard by the COARSE
            # level's group count so the restricted vector lands in the
            # next level's layout
            if lvl.R is not None:
                kc = _level_groups(lvl.R.n_pad, ndev, min_local_rows)
                R = (_shard_op(_submesh(mesh, kc, axis), lvl.R, axis)
                     if kc > 1 else _replicate(mesh, lvl.R))
            else:
                R = None
        else:
            # agglomerated: replicate on every device of the mesh (left
            # as is, the arrays would stay on the default device alone)
            A, Pop, R = _replicate(mesh, (lvl.A, lvl.P, lvl.R))
        new_levels.append(DeviceLevel(
            A=A, P=Pop, R=R, pre=lvl.pre, post=lvl.post,
            n=lvl.n, n_pad=lvl.n_pad))
    return DeviceHierarchy(
        levels=new_levels,
        coarse_inv=jax.device_put(
            hierarchy.coarse_inv, NamedSharding(mesh, P(None, None))),
        nc=hierarchy.nc, nc_pad=hierarchy.nc_pad, dtype=hierarchy.dtype,
    )
