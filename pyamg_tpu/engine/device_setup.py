"""Device (jitted) SA setup — the on-device hierarchy construction path.

Round-1 verdict item #1: the host setup phase (NumPy/SciPy + C++) costs
14.5 s at 4.2M unknowns vs 4.4 s solve — it dominated end-to-end time
and cannot scale.  BASELINE.json:5 names "setup-phase graph algorithms
(strength, aggregation, splitting) as parallel JAX primitives" as a
subsystem that changes; this module is that subsystem for the SA family
(reference counterpart: [R] pyamg/aggregation/aggregation.py
_extend_hierarchy + amg_core standard_aggregation/fit_candidates,
SURVEY.md §3.1).

The design is made for the device, not a port.  The reference's serial greedy
aggregation + per-aggregate QR + CSR SpGEMM become, for operators on
regular grids (the gallery's stencil problems — BASELINE configs 1-4):

- **structured aggregation**: aggregates are stride^d grid blocks
  (stride 3 ~ the aggregate diameter standard_aggregation produces on
  stencil graphs).  No graph algorithm needed — the aggregate map is
  index arithmetic, and per-aggregate candidate norms (the QR of a
  single column) are a reshape + block-sum.
- **embedded transfer operators**: the tentative/smoothed prolongator is
  stored as an n×n DIAMatrix on the *fine* grid whose columns live only
  on aggregate-center positions.  P/R application = rolls plus pure
  reshape/broadcast embed/compact between grids — ZERO gathers
  (DESIGN.md rule 1), all static shapes.
- **RAP on device**: Galerkin triple product via `dia_spgemm` with a
  static output-offset filter (only offsets ≡ 0 mod stride per grid dim
  survive compaction — everything else is structurally zero because R
  rows / P columns live on centers only).
- **compaction**: coarse operator/vector extraction is a strided
  reshape-slice (`y.reshape(ncy, s, ncx, s)[:, c, :, c]`), the exact
  inverse of the broadcast embed.  XLA compiles both to pure data
  movement.

Every level step is one jitted function of the previous level's arrays;
the only host work is the initial scipy→DIA conversion and the per-level
`float(rho)` pulls that feed the *static* smoother configs.

Scope/contract: scalar operators laid out row-major on a rectangular
grid (2-D or 3-D), single near-nullspace candidate (the SA default
B=ones).  Strength-adaptive aggregation, BSR blocks, and unstructured
operators stay on the host setup path (`smoothed_aggregation_solver` +
`compile_hierarchy`), which remains the parity reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Tuple

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp
from jax import lax

from ..sparse import DIAMatrix, dia_from_scipy
from ..sparse.dia import dia_spgemm
from . import relaxation as device_relaxation
from .hierarchy import DeviceHierarchy, DeviceLevel
from .setup import _hash_weights
from .solver import DeviceMultilevelSolver

__all__ = [
    "detect_grid",
    "device_adaptive_sa_setup",
    "device_sa_setup",
    "StructuredProlongator",
    "StructuredRestrictor",
    "dia_transpose",
    "StructuredDeviceSolver",
]


def detect_grid(A):
    """Infer the row-major grid shape of a stencil operator from its
    sparsity offsets (best effort — pass ``grid`` explicitly when you
    know it).

    The distinct structural offsets of a grid stencil are sums of
    per-dim unit steps: ±1 for the fastest dim, ±nx (± 1) for the next
    (9-point stencils add the diagonals nx±1), ±nx·ny (± …) for 3-D.
    Recovery: the fastest-dim extent is the smallest offset > 2 present
    as {o-1, o, o+1} (FE) or bare o (FD); recurse on offsets/extent.
    Raises ValueError when no consistent grid exists.
    """
    A = sp.csr_matrix(A)
    n = A.shape[0]
    coo = A.tocoo()
    signed = np.unique(coo.col - coo.row)
    # a d-dim stencil has at most 3^d distinct offsets (27 for 3-D
    # 27-point; blocked elasticity ~21); a PERMUTED operator has
    # O(bandwidth) distinct offsets (measured: RCM'd 48^2 advection ->
    # 95) yet its offset set can still "factor" into a bogus grid —
    # round 5 caught detect_grid returning (48, 3, 4, 4) for exactly
    # that matrix, which would route it down the structured path with
    # wrong semantics.
    if len(signed) > 49:
        raise ValueError(
            f"{len(signed)} distinct structural offsets — not a grid "
            "stencil; pass grid= explicitly or use the unstructured "
            "path")
    offs = np.unique(np.abs(signed))
    offs = offs[offs > 0]

    def next_extent(offs, limit):
        """Smallest plausible extent from offsets in (2, limit]."""
        big = offs[offs > 2]
        if len(big) == 0:
            return None
        o = int(big[0])
        s = set(offs.tolist())
        if o + 2 in s and o + 1 in s:
            return o + 1          # {nx-1, nx, nx+1} diagonals (FE)
        if o + 2 in s:
            return o + 1          # {nx-1, nx+1} without nx
        return o                  # bare nx (FD)

    dims = []
    cur = 1
    while True:
        rel = np.unique(offs[offs % cur == 0] // cur)
        rel = rel[rel > 0]
        ext = next_extent(rel, n)
        if ext is None:
            break
        cur *= ext
        dims.append(ext)
        if cur >= n:
            break
    if cur == 0 or n % max(cur, 1) != 0:
        raise ValueError(
            f"could not infer a grid from offsets {offs[:8].tolist()}…; "
            "pass grid= explicitly")
    lead = n // cur
    grid = (lead,) + tuple(reversed(dims)) if lead > 1 else tuple(
        reversed(dims))
    if int(np.prod(grid)) != n or len(grid) == 0:
        raise ValueError(
            f"inferred grid {grid} does not match n={n}; pass grid= "
            "explicitly")
    return grid


# ---------------------------------------------------------------------------
# offset <-> grid-coordinate bookkeeping (host, static)
# ---------------------------------------------------------------------------

def _offset_to_coords(o, grid):
    """Decompose a row-major linear offset into per-dim deltas.

    grid = (..., ny, nx); valid for stencil offsets whose per-dim delta
    magnitude is < dim/2 (always true for the gallery stencils).
    """
    coords = []
    for d in range(len(grid) - 1, -1, -1):
        size = grid[d]
        delta = ((o + size // 2) % size) - size // 2
        coords.append(int(delta))
        o = (o - delta) // size
    if o != 0:
        raise ValueError("offset does not decompose on this grid")
    return tuple(reversed(coords))


def _coords_to_offset(coords, grid):
    # row-major: offset = sum_d coords[d] * prod(grid[d+1:])
    o = 0
    stride = 1
    for d in range(len(grid) - 1, -1, -1):
        o += coords[d] * stride
        stride *= grid[d]
    return int(o)


def _tup(v, dim):
    """Normalize a per-dim parameter: int -> (v,)*dim, tuple -> tuple.
    Lets every grid helper take anisotropic (per-dim) strides/centers —
    the semicoarsening device setup — while scalar callers stay as-is."""
    if isinstance(v, (tuple, list)):
        if len(v) != dim:
            raise ValueError(f"expected {dim} per-dim values, got {v}")
        return tuple(int(x) for x in v)
    return (int(v),) * dim


def _padded_grid(grid, stride, lane_align=None):
    """Stride-padded grid; with ``lane_align`` the LAST dim also pads
    to a multiple of lcm(stride, 128) and the second-to-last to
    lcm(stride, 8), so a flat device vector REINTERPRETS as the
    2-D/3-D grid with row widths a multiple of 128.  Default off; the
    padded rows cost ~12% more traffic at 2048^2, and no GPU
    measurement yet shows a gain from the alignment (ROADMAP D7)."""
    import math

    ss = _tup(stride, len(grid))
    if lane_align is None:
        lane_align = _LANE_ALIGN_DEFAULT
    out = []
    nd = len(grid)
    for d, (g, s) in enumerate(zip(grid, ss)):
        q = s
        if lane_align and d == nd - 1 and g >= 512:
            q = s * 128 // math.gcd(s, 128)
        elif lane_align and d == nd - 2 and g >= 64:
            q = s * 8 // math.gcd(s, 8)
        out.append(int(q * -(-g // q)))
    return tuple(out)


_LANE_ALIGN_DEFAULT = False


# ---------------------------------------------------------------------------
# pure-data-movement grid transforms (device, jit-safe)
# ---------------------------------------------------------------------------

def _grid_pad_vec(v, grid, grid_p):
    """Zero-pad a grid vector (row-major) to the padded grid layout."""
    v = v[: int(np.prod(grid))].reshape(grid)
    pads = [(0, gp - g) for g, gp in zip(grid, grid_p)]
    return jnp.pad(v, pads).reshape(-1)


def _grid_unpad_vec(v, grid, grid_p):
    v = v.reshape(grid_p)
    sl = tuple(slice(0, g) for g in grid)
    return v[sl].reshape(-1)


def _embed_coarse(xc, coarse_grid, stride, center):
    """Coarse grid vector -> fine padded grid with values at centers.

    Implemented as `lax.pad` with INTERIOR padding — the native XLA
    dilation op, the exact inverse of the strided-slice compaction.
    (The obvious reshape-broadcast form creates (..., nc, stride)
    intermediates with a tiny minor dimension.)
    """
    dim = len(coarse_grid)
    ss = _tup(stride, dim)
    cc = _tup(center, dim)
    y = xc.reshape(coarse_grid)
    cfg = [(c, s - 1 - c, s - 1) for s, c in zip(ss, cc)]
    y = lax.pad(y, jnp.zeros((), dtype=xc.dtype), cfg)
    return y.reshape(-1)


def _compact_fine(v, coarse_grid, stride, center):
    """Fine padded grid vector -> values at aggregate centers.

    Strided slice on the grid-shaped view — native data movement, large
    minor dims throughout.
    """
    dim = len(coarse_grid)
    ss = _tup(stride, dim)
    cc = _tup(center, dim)
    fine_p = tuple(g * s for g, s in zip(coarse_grid, ss))
    v = v.reshape(fine_p)
    idx = tuple(slice(c, None, s) for s, c in zip(ss, cc))
    return v[idx].reshape(-1)


@partial(jax.jit, static_argnums=(1,))
def _dia_transpose_data(data, offsets):
    """All transpose rolls in ONE program (cached on the static offsets
    signature) — the eager per-diagonal form dispatched and compiled one
    roll program per distinct shift."""
    lookup = {o: d for d, o in enumerate(offsets)}
    out_offsets = tuple(sorted(-o for o in offsets))
    return jnp.stack([
        jnp.roll(data[lookup[-p]], -p) for p in out_offsets])


def dia_transpose(A: DIAMatrix) -> DIAMatrix:
    """Transpose of a DIAMatrix, by rolls only.

    B = A^T has B_data[-o][j] = A_data[o][j + (-o)... derived:
    B[j, j+p] = A[j+p, j] = A_data[d(-p)][j+p], so
    B_data[p] = roll(A_data[d(-p)], -p).  Wrap-around entries land on
    positions whose source entries are stored as zero, so they vanish.
    """
    offsets = tuple(sorted(-o for o in A.offsets))
    data = _dia_transpose_data(A.data, A.offsets)
    return DIAMatrix(data=data, offsets=offsets,
                     shape=(A.shape[1], A.shape[0]), nnz=A.nnz)


def _dia_spgemm_filtered(A: DIAMatrix, B: DIAMatrix, keep_offsets):
    """C = A @ B keeping only static `keep_offsets` (structural filter).

    Used for the R·(A·P) product: output offsets that are not ≡ 0 mod
    stride per grid dim are structurally zero (rows/cols live on
    aggregate centers) — skipping them avoids materializing O(span^d)
    dead diagonals.
    """
    keep = set(int(o) for o in keep_offsets)
    acc = {}
    for da, oa in enumerate(A.offsets):
        a = A.data[da]
        for db, ob in enumerate(B.offsets):
            oc = oa + ob
            if oc not in keep:
                continue
            term = a * jnp.roll(B.data[db], -oa)
            acc[oc] = acc[oc] + term if oc in acc else term
    offsets = tuple(sorted(acc.keys()))
    data = jnp.stack([acc[o] for o in offsets])
    return DIAMatrix(data=data, offsets=offsets,
                     shape=(A.shape[0], B.shape[1]),
                     nnz=len(offsets) * A.shape[0])


def _compact_dia(A_emb: DIAMatrix, grid_p, stride, center) -> DIAMatrix:
    """Extract the coarse operator from its fine-grid embedding.

    Rows: center positions (reshape-slice).  Offsets: each embedded
    offset decomposes into per-dim deltas that are multiples of stride;
    the coarse offset is the same delta / stride on the coarse grid.
    """
    dim = len(grid_p)
    ss = _tup(stride, dim)
    coarse_grid = tuple(g // s for g, s in zip(grid_p, ss))
    out_offsets = []
    rows = []
    for d, o in enumerate(A_emb.offsets):
        coords = _offset_to_coords(o, grid_p)
        assert all(c % s == 0 for c, s in zip(coords, ss)), (o, coords)
        cc = tuple(c // s for c, s in zip(coords, ss))
        out_offsets.append(_coords_to_offset(cc, coarse_grid))
        rows.append(_compact_fine(A_emb.data[d], coarse_grid, stride,
                                  center))
    order = np.argsort(out_offsets)
    data = jnp.stack([rows[i] for i in order])
    offsets = tuple(int(out_offsets[i]) for i in order)
    nc = int(np.prod(coarse_grid))
    return DIAMatrix(data=data, offsets=offsets, shape=(nc, nc),
                     nnz=len(offsets) * nc)


# ---------------------------------------------------------------------------
# structured transfer operators (solve-phase pytrees)
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class StructuredProlongator:
    """P = S_smooth · T, applied FACTORED: coarse padded-grid vector ->
    fine padded-grid vector via

        P @ xc  =  S @ ( tv * spread(embed(xc)) )

    where tv is the per-point normalized tentative value and spread is
    the stride^d-roll aggregate broadcast.  Costs ~1 DIA SpMV + stride^d
    cheap rolls — vs (2*stride-1)^d full rolls for the materialized
    embedded P.  The
    coarse side uses the coarse level's padded grid layout.
    """

    S: DIAMatrix                     # smoothing operator (I - w D^-1 A)
    tv: jnp.ndarray                  # (n_fine_pad,) tentative values
    fine_grid_p: Tuple[int, ...]     # static
    coarse_grid: Tuple[int, ...]     # = fine_grid_p // stride
    coarse_grid_p: Tuple[int, ...]   # next level's padded grid
    stride: int
    center: int

    def tree_flatten(self):
        return (self.S, self.tv), (self.fine_grid_p, self.coarse_grid,
                                   self.coarse_grid_p, self.stride,
                                   self.center)

    @classmethod
    def tree_unflatten(cls, aux, children):
        S, tv = children
        f, c, cp, s, ctr = aux
        return cls(S=S, tv=tv, fine_grid_p=f, coarse_grid=c,
                   coarse_grid_p=cp, stride=s, center=ctr)

    @property
    def nnz(self):
        # structural estimate: T contributes one entry per fine point,
        # smoothing widens each column by the stencil
        return int(np.prod(self.fine_grid_p)) * self.S.ndiags

    @property
    def shape(self):
        return (int(np.prod(self.fine_grid_p)),
                int(np.prod(self.coarse_grid_p)))

    def _smooth_input(self, xc):
        xc = xc[: int(np.prod(self.coarse_grid_p))]
        xc = _grid_unpad_vec(xc, self.coarse_grid, self.coarse_grid_p)
        t = self.tv * _broadcast_coarse(xc, self.coarse_grid, self.stride,
                                        self.center)
        nf = int(np.prod(self.fine_grid_p))
        if self.S.n_pad != nf:
            t = jnp.pad(t, (0, self.S.n_pad - nf))
        return t

    def __matmul__(self, xc):
        # the grid semantics live in the leading prod(coarse_grid_p)
        # entries of xc
        return self.S @ self._smooth_input(xc)


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class StructuredRestrictor:
    """R = P^T = T^T · S^T, applied factored:

        R @ r  =  pad( block_sum( tv * (S^T @ r) ) )

    block_sum is the per-aggregate reduce_window sum (T^T)."""

    St: DIAMatrix                    # S^T
    tv: jnp.ndarray
    fine_grid_p: Tuple[int, ...]
    coarse_grid: Tuple[int, ...]
    coarse_grid_p: Tuple[int, ...]
    stride: int
    center: int

    def tree_flatten(self):
        return (self.St, self.tv), (self.fine_grid_p, self.coarse_grid,
                                    self.coarse_grid_p, self.stride,
                                    self.center)

    @classmethod
    def tree_unflatten(cls, aux, children):
        St, tv = children
        f, c, cp, s, ctr = aux
        return cls(St=St, tv=tv, fine_grid_p=f, coarse_grid=c,
                   coarse_grid_p=cp, stride=s, center=ctr)

    @property
    def nnz(self):
        return int(np.prod(self.fine_grid_p)) * self.St.ndiags

    @property
    def shape(self):
        return (int(np.prod(self.coarse_grid_p)),
                int(np.prod(self.fine_grid_p)))

    @property
    def n_pad(self):
        return int(np.prod(self.coarse_grid_p))

    def __matmul__(self, r):
        # r arrives at the level's n_pad = St.n_pad; the grid semantics
        # live in the leading prod(fine_grid_p) entries
        nf = int(np.prod(self.fine_grid_p))
        y = (self.St @ r)[:nf] * self.tv[:nf]
        yc = _block_sum(y, self.coarse_grid, self.stride)
        return _grid_pad_vec(yc, self.coarse_grid, self.coarse_grid_p)


# ---------------------------------------------------------------------------
# device level step
# ---------------------------------------------------------------------------

def _relayout_dia(dia: DIAMatrix, grid, grid_p) -> DIAMatrix:
    """Re-lay a DIA operator from grid layout onto the padded grid."""
    if tuple(grid) == tuple(grid_p) and dia.n_pad == int(np.prod(grid)):
        return dia
    n = int(np.prod(grid))
    rows = []
    offsets = []
    for d, o in enumerate(dia.offsets):
        coords = _offset_to_coords(o, grid)
        offsets.append(_coords_to_offset(coords, grid_p))
        rows.append(_grid_pad_vec(dia.data[d][:n], grid, grid_p))
    order = np.argsort(offsets)
    return DIAMatrix(
        data=jnp.stack([rows[i] for i in order]),
        offsets=tuple(int(offsets[i]) for i in order),
        shape=(int(np.prod(grid_p)),) * 2,
        nnz=dia.nnz)


def _block_norms(B, coarse_grid, stride):
    """Per-aggregate 2-norm of the candidate (fit_candidates' QR for a
    single column) via `lax.reduce_window` block sums."""
    dim = len(coarse_grid)
    ss = _tup(stride, dim)
    fine_p = tuple(g * s for g, s in zip(coarse_grid, ss))
    sq = (B * B).reshape(fine_p)
    s = lax.reduce_window(sq, jnp.zeros((), dtype=sq.dtype), lax.add,
                          ss, ss, "VALID")
    return jnp.sqrt(s).reshape(-1)


def _dim_mats(coarse_grid, ss, cc, kind):
    """Per-dim one-hot transfer matrices (trace-time iota, f32).

    kind='spread': (fg_d, cg_d) with 1 at rows c*s..c*s+s-1 (broadcast
    each coarse value over its aggregate); kind='embed': 1 only at the
    center row c*s+center.  Used CONTRACTED for block_sum.
    """
    mats = []
    for g, s, c in zip(coarse_grid, ss, cc):
        f = jnp.arange(g * s)[:, None]
        co = jnp.arange(g)[None, :]
        if kind == "embed":
            m = (f == co * s + c)
        else:
            m = (f // s == co)
        mats.append(m.astype(jnp.float32))
    return mats


def _spread_contract(v, mats, transpose):
    """Contract each grid dim of v (lead batch dims allowed) with its
    one-hot matrix: the contraction form of embed/broadcast/block_sum.

    EXACT (Precision.HIGHEST) everywhere: a reduced-precision form
    (a split bf16 product, or TF32 at default precision on the GPU)
    rounds the spread (prolong) and block_sum (restrict) directions
    differently, so R stops being P^T to fp accuracy and the V-cycle
    preconditioner loses the symmetry CG requires (an earlier split
    form cost 5-17 extra CG iterations at >=1024^2).  Exact one-hot
    selection keeps the transfer pair an exact transpose pair (spread
    is rounding-free; block_sum rounds only in f32 addition).  The
    dot_general forms batch natively under vmap."""
    nbatch = v.ndim - len(mats)

    def apply(p, dtype, acc_dtype):
        out = p
        for d, M in enumerate(mats):
            Md = M.T if transpose else M
            out = jnp.moveaxis(
                jnp.tensordot(out, Md.astype(dtype),
                              axes=((nbatch + d,), (1,)),
                              preferred_element_type=acc_dtype,
                              precision=lax.Precision.HIGHEST),
                -1, nbatch + d)
        return out

    return apply(v, v.dtype, v.dtype)


def _block_sum(v, coarse_grid, stride):
    """Per-aggregate sum of a fine padded-grid vector (one-hot
    contraction per dim — see _spread_contract; vmap batches the
    dot_generals natively)."""
    dim = len(coarse_grid)
    ss = _tup(stride, dim)
    fine_p = tuple(g * s for g, s in zip(coarse_grid, ss))
    mats = _dim_mats(coarse_grid, ss, (0,) * dim, "spread")
    return _spread_contract(v.reshape(fine_p), mats,
                            transpose=True).reshape(-1)


def _broadcast_coarse(vc, coarse_grid, stride, center):
    """Replicate each coarse value over its stride^d fine block
    (out[f] = vc[f // stride] per dim) via the per-dim one-hot
    contraction — see _spread_contract.  ``center`` is immaterial for
    the broadcast (every point of an aggregate reads the same coarse
    value); kept for signature parity.  The dot_general form batches
    natively under vmap."""
    dim = len(coarse_grid)
    ss = _tup(stride, dim)
    mats = _dim_mats(coarse_grid, ss, (0,) * dim, "spread")
    return _spread_contract(vc.reshape(coarse_grid), mats,
                            transpose=False).reshape(-1)


def _tentative_emb(B, grid_p, stride, center, dtype) -> Tuple[DIAMatrix,
                                                              jnp.ndarray]:
    """Embedded tentative prolongator T and coarse candidate B_c.

    T[i, r(i)] = B[i] / ||B||_{agg(i)} — per-aggregate normalized
    candidate (exactly fit_candidates for one column, [R]
    pyamg/aggregation/tentative.py::fit_candidates).  As an embedded
    DIA: offset (r(i) - i) per dim ∈ {center - (i % stride)}, selected
    by static iota masks.
    """
    dim = len(grid_p)
    ss = _tup(stride, dim)
    cc = _tup(center, dim)
    coarse_grid = tuple(g // s for g, s in zip(grid_p, ss))
    norms = _block_norms(B, coarse_grid, stride)
    norms_f = _broadcast_coarse(norms, coarse_grid, stride, center)
    tv = jnp.where(norms_f > 0, B / jnp.where(norms_f > 0, norms_f, 1), 0)

    # per-dim position-within-aggregate masks (trace-time iota)
    pos = [jnp.arange(g) % s for g, s in zip(grid_p, ss)]

    offsets = []
    rows = []
    for combo in np.ndindex(*[2 * s - 1 for s in ss]):
        coords = tuple(int(c) - (s - 1) for c, s in zip(combo, ss))
        # fine point at in-block position p gets root offset center - p,
        # so diagonal `coords` selects points with p == center - coords
        masks = []
        ok = True
        for d in range(dim):
            want = cc[d] - coords[d]
            if not (0 <= want < ss[d]):
                ok = False
                break
            masks.append(pos[d] == want)
        if not ok:
            continue
        shape = [1] * dim
        shape[0] = grid_p[0]
        m = masks[0].reshape(shape)
        for d in range(1, dim):
            shape = [1] * dim
            shape[d] = grid_p[d]
            m = m & masks[d].reshape(shape)
        offsets.append(_coords_to_offset(coords, grid_p))
        rows.append(jnp.where(m.reshape(-1), tv, 0).astype(dtype))
    order = np.argsort(offsets)
    T = DIAMatrix(
        data=jnp.stack([rows[i] for i in order]),
        offsets=tuple(int(offsets[i]) for i in order),
        shape=(int(np.prod(grid_p)),) * 2,
        nnz=int(np.prod(grid_p)))
    return T, norms, tv.astype(dtype)


def _power_rho(A: DIAMatrix, dinv=None, iters=40):
    """Spectral-radius estimate of (D^-1) A by power iteration.

    Device analog of util.linalg.approximate_spectral_radius for the
    smoother omega scaling; convergence-factor parity absorbs the small
    estimator difference (SURVEY.md §7 hard part 3).
    """
    n_pad = A.n_pad
    v0 = (_hash_weights(n_pad, 12345).astype(A.dtype) - 0.5)
    v0 = jnp.where(A.diagonal() != 0, v0, 0)
    v0 = v0 / jnp.linalg.norm(v0)

    def body(_, v):
        w = A @ v
        if dinv is not None:
            w = dinv * w
        nrm = jnp.linalg.norm(w)
        return w / jnp.where(nrm == 0, 1, nrm)

    v = lax.fori_loop(0, iters, body, v0)
    w = A @ v
    if dinv is not None:
        w = dinv * w
    return jnp.linalg.norm(w)


def _spec_key(spec):
    """Normalize a ('name', kwargs) smoother spec to a hashable key."""
    if spec is None:
        return None
    name, kwargs = spec if isinstance(spec, tuple) else (spec, {})
    if name is None:
        return None
    return (str(name), tuple(sorted((k, _hashable(v))
                                    for k, v in dict(kwargs or {}).items())))


def _hashable(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, (list, np.ndarray)):
        return tuple(np.asarray(v).ravel().tolist())
    return v


def _smoother_device_arrays(key, A_p, dinv, rho_dinv, dtype):
    """TRACED: device arrays (dynamic omegas/coefficients) for a spec.

    Everything stays on device — no scalar is pulled to the host during
    setup, so the setup stays one asynchronous program."""
    if key is None:
        return ()
    name, kw = key
    kw = dict(kw)
    if name == "jacobi":
        omega = jnp.asarray(float(kw.get("omega", 1.0)), dtype=dtype)
        if kw.get("withrho", True):
            omega = omega / jnp.maximum(rho_dinv, 1e-30)
        return (dinv, omega)
    if name == "richardson":
        rho_A = _power_rho(A_p)
        omega = jnp.asarray(float(kw.get("omega", 1.0)),
                            dtype=dtype) / jnp.maximum(rho_A, 1e-30)
        return (omega,)
    if name == "chebyshev":
        from ..relaxation.chebyshev import chebyshev_polynomial_coefficients

        lower = float(kw.get("lower_bound", 1.0 / 30.0))
        upper = float(kw.get("upper_bound", 1.1))
        degree = int(kw.get("degree", 3))
        # coefficients for the UNIT interval [lower, upper]; scaling the
        # interval by rho scales coefficient j of t^(degree-1-j) by
        # rho^-(degree-j) (p_rho(t) = p_unit(t/rho)/rho)
        c_unit = np.asarray(
            chebyshev_polynomial_coefficients(lower, upper, degree))
        rho_A = _power_rho(A_p)
        exps = degree - np.arange(degree)
        coeffs = jnp.asarray(c_unit, dtype=dtype) * (
            jnp.maximum(rho_A, 1e-30) ** jnp.asarray(-exps, dtype=dtype))
        return (coeffs,)
    raise ValueError(
        f"device setup supports jacobi/richardson/chebyshev, got {name!r}")


def _smoother_wrap(key, arrays):
    """HOST: bind pulled-free device arrays into a DeviceSmoother."""
    if key is None:
        return device_relaxation.identity()
    name, kw = key
    kw = dict(kw)
    iterations = int(kw.get("iterations", 1))
    if name == "jacobi":
        return device_relaxation.jacobi_dyn(arrays[0], arrays[1],
                                            iterations)
    if name == "richardson":
        return device_relaxation.richardson_dyn(arrays[0], iterations)
    if name == "chebyshev":
        return device_relaxation.polynomial_dyn(arrays[0], iterations)
    raise ValueError(name)


@partial(jax.jit, static_argnames=("plan", "omega", "dtype",
                                   "pre_key", "post_key",
                                   "improve_iters"))
def _setup_pipeline(A_in, B_in=None, *, plan, omega, dtype, pre_key,
                    post_key, improve_iters=0):
    """The ENTIRE multi-level SA setup as ONE XLA program.

    plan: static tuple of (grid, grid_p, strides) per level — per-dim
    strides enable SEMICOARSENING on anisotropic problems (stride 1 in
    weak-coupling dims).  One program instead of one per level + one per
    smoother: each distinct executable pays its own compile and launch,
    so program count dominates cold setup latency.  Returns per-level
    operator pytrees, rho estimates, smoother arrays, plus the dense
    coarse operator and its on-device pseudo-inverse — zero host
    round-trips.
    """
    cur = A_in
    B = None
    out_levels = []
    for (grid, grid_p, strides) in plan:
        center = tuple(s // 2 for s in strides)
        A_p = _relayout_dia(cur, grid, grid_p)
        if B is None:
            if B_in is not None:
                # user-supplied near-nullspace candidate (level 0)
                Bv = _grid_pad_vec(
                    jnp.asarray(B_in, dtype=dtype)[: int(np.prod(grid))],
                    grid, grid_p)
                Bv = jnp.where(A_p.diagonal() != 0, Bv, 0)
            else:
                Bv = jnp.where(A_p.diagonal() != 0,
                               jnp.ones(A_p.n_pad, dtype=dtype), 0)
        else:
            Bv = _grid_pad_vec(B[: int(np.prod(grid))], grid, grid_p)
        diag = A_p.diagonal()
        dinv = jnp.where(diag != 0,
                         1.0 / jnp.where(diag != 0, diag, 1), 0)
        rho = _power_rho(A_p, dinv)
        # improve_candidates ([R] pyamg/aggregation/aggregation.py
        # default: relax A z = 0 on the candidate before fitting the
        # tentative — essential when the near-nullspace is not exactly
        # representable, e.g. diagonally rescaled operators; measured:
        # rescaled 64^2 Poisson rho 0.82 -> 0.36 with 4 sweeps)
        omega_imp = 1.0 / jnp.maximum(rho, 1e-30)
        for _ in range(improve_iters):
            Bv = Bv - omega_imp * (dinv * (A_p @ Bv))
        if improve_iters:
            Bv = Bv / jnp.maximum(jnp.max(jnp.abs(Bv)), 1e-30)
        S_op, St_op, tv, A_c, Bc, rho = _coarsen_level(
            A_p, Bv, grid_p, strides, center, omega, dtype, rho=rho)
        pre_arr = _smoother_device_arrays(pre_key, A_p, dinv, rho, dtype)
        post_arr = _smoother_device_arrays(post_key, A_p, dinv, rho,
                                           dtype)
        out_levels.append((A_p, S_op, St_op, tv, rho, pre_arr, post_arr))
        cur = A_c
        B = Bc
    Ac_dense = cur @ jnp.eye(cur.n_pad, dtype=dtype)
    coarse_inv = _ns_pinv(Ac_dense)
    return tuple(out_levels), Ac_dense, coarse_inv


def _ns_pinv(A, iters=60):
    """Newton-Schulz (Ben-Israel--Cohen) pseudo-inverse — pure matmuls
    inside the one-program setup, no SVD.

    X0 = A^T / (||A||_1 ||A||_inf) guarantees ||I - X0 A|| < 1 on
    range(A); X <- X (2I - A X) then converges quadratically to pinv(A)
    (zero padding rows/cols stay exactly zero).  60 iterations cover
    cond(A) up to ~1e6 at f32 accuracy — far beyond any AMG coarsest
    operator."""
    n = A.shape[0]
    at = A.T
    norm1 = jnp.max(jnp.sum(jnp.abs(A), axis=0))
    norminf = jnp.max(jnp.sum(jnp.abs(A), axis=1))
    alpha = 1.0 / jnp.maximum(norm1 * norminf, 1e-30)
    X0 = alpha * at
    eye2 = 2.0 * jnp.eye(n, dtype=A.dtype)

    def body(_, X):
        # HIGHEST: the Newton-Schulz iterates must converge to f32
        # accuracy; default-precision f32 dots may run in TF32 on the
        # GPU and would cap the achievable pinv residual
        return jnp.dot(X, eye2 - jnp.dot(A, X,
                                         preferred_element_type=A.dtype,
                                         precision=lax.Precision.HIGHEST),
                       preferred_element_type=A.dtype,
                       precision=lax.Precision.HIGHEST)

    return lax.fori_loop(0, iters, body, X0)


def _coarsen_level(A_p: DIAMatrix, B, grid_p, stride, center, omega, dtype,
                   rho=None):
    """One device SA coarsening step on the padded grid.

    Returns (P_emb, R_emb, A_c on coarse grid, B_c).  Jitted by the
    caller with static grid/stride.  ``rho`` (spectral radius of
    D^-1 A) may be passed in when the caller already estimated it for
    the candidate-improvement sweeps."""
    diag = A_p.diagonal()
    dinv = jnp.where(diag != 0, 1.0 / jnp.where(diag != 0, diag, 1), 0)
    T, Bc, tv = _tentative_emb(B, grid_p, stride, center, dtype)
    if rho is None:
        rho = _power_rho(A_p, dinv)
    # S = I - (omega/rho) D^-1 A_dir as a DIA (row-scaled + identity
    # bump).  A_dir drops offsets that move along UNCOARSENED (stride-1)
    # dims: smoothing P along weak directions both wastes work (the
    # couplings there are O(eps) under semicoarsening) and grows the
    # coarse stencil by ±span per level in those dims (unbounded ndiags
    # — measured 5 -> 17 -> ... on anisotropic diffusion).  This is the
    # structured analog of strength-filtered prolongation smoothing
    # ([R] pyamg/aggregation/smooth.py jacobi_prolongation_smoother's C
    # filter, SURVEY.md §2.2).  Isotropic strides keep every offset.
    ss_dir = _tup(stride, len(grid_p))
    s_keep = [d for d, o in enumerate(A_p.offsets)
              if all(c == 0 or s > 1 for c, s in
                     zip(_offset_to_coords(o, grid_p), ss_dir))]
    s_offsets = tuple(A_p.offsets[d] for d in s_keep)
    scale = -(omega / jnp.where(rho == 0, 1, rho))
    # static row selection (never a traced gather: DESIGN.md rule 1)
    s_data = (jnp.stack([A_p.data[d] for d in s_keep])
              * (scale * dinv)[None, :]) if s_keep else None
    if 0 in s_offsets:
        d0 = s_offsets.index(0)
        s_data = s_data.at[d0].add(jnp.where(diag != 0, 1.0, 0.0))
        S = DIAMatrix(data=s_data, offsets=s_offsets, shape=A_p.shape,
                      nnz=A_p.nnz)
    else:
        bump = jnp.where(diag != 0, 1.0, 0.0)[None, :]
        s_data = (jnp.concatenate([s_data, bump]) if s_data is not None
                  else bump)
        S = DIAMatrix(data=s_data, offsets=s_offsets + (0,),
                      shape=A_p.shape, nnz=A_p.nnz)
    P_emb = dia_spgemm(S, T)
    R_emb = dia_transpose(P_emb)
    St = dia_transpose(S)
    AP = dia_spgemm(A_p, P_emb)
    # structural filter: only center-to-center offsets (every per-dim
    # delta ≡ 0 mod stride) survive compaction — enumerate candidates
    # from the actual operand offsets
    ss = _tup(stride, len(grid_p))
    cand = set()
    for oa in R_emb.offsets:
        for ob in AP.offsets:
            oc = oa + ob
            try:
                coords = _offset_to_coords(oc, grid_p)
            except ValueError:
                continue
            if all(c % s == 0 for c, s in zip(coords, ss)):
                cand.add(oc)
    Ac_emb = _dia_spgemm_filtered(R_emb, AP, cand)
    A_c = _compact_dia(Ac_emb, grid_p, stride, center)
    # solve phase stores the FACTORED transfer (S, S^T, tv) — applying
    # P = S·T as smooth(spread(xc)) costs ~1 SpMV + stride^d rolls,
    # vs ~(2·stride-1)^d rolls for the materialized embedded P (the
    # embedded forms exist only transiently for the RAP above)
    return S, St, tv, A_c, Bc, rho


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

class StructuredDeviceSolver(DeviceMultilevelSolver):
    """DeviceMultilevelSolver whose level-0 vector space is a padded
    grid: encodes b / decodes x with pure reshape-pad (host numpy)."""

    def __init__(self, hierarchy, grid, grid_p, setup_info=None):
        super().__init__(hierarchy)
        self.grid = tuple(grid)
        self.grid_p = tuple(grid_p)
        self.setup_info = setup_info or {}

    def _encode(self, v):
        """Grid-pad a vector — or an (n, K) column stack (the batched
        multi-RHS path) — to the padded-grid layout.  Device arrays are
        re-laid ON DEVICE (reshape+pad, no host round-trip)."""
        xp = jnp if isinstance(v, jnp.ndarray) else np
        v = v if isinstance(v, jnp.ndarray) else np.asarray(v)
        if v.ndim == 2:
            K = v.shape[1]
            v = v.reshape(self.grid + (K,))
            pads = [(0, gp - g)
                    for g, gp in zip(self.grid, self.grid_p)] + [(0, 0)]
            return xp.pad(v, pads).reshape(-1, K)
        v = v.reshape(self.grid)
        pads = [(0, gp - g) for g, gp in zip(self.grid, self.grid_p)]
        return xp.pad(v, pads).reshape(-1)

    def _decode(self, v):
        v = v if isinstance(v, jnp.ndarray) else np.asarray(v)
        sl = tuple(slice(0, g) for g in self.grid)
        if v.ndim == 2:
            K = v.shape[1]
            return v.reshape(self.grid_p + (K,))[sl].reshape(-1, K)
        v = v.reshape(self.grid_p)
        return v[sl].reshape(-1)

    def solve(self, b, x0=None, **kw):
        b = self._encode(b)
        if x0 is not None:
            x0 = self._encode(x0)
        x = super().solve(b, x0=x0, **kw)
        if isinstance(x, tuple):
            return (self._decode(x[0]),) + x[1:]
        return self._decode(x)

    def aspreconditioner(self, cycle="V"):
        from scipy.sparse.linalg import LinearOperator

        inner = super().aspreconditioner(cycle)
        n = int(np.prod(self.grid))

        def matvec(r):
            return self._decode(inner @ self._encode(r))

        return LinearOperator((n, n), matvec=matvec, dtype=np.float64)


def device_sa_setup(A, grid=None, B=None, dtype=jnp.float32, omega=4.0 / 3.0,
                    stride=3, max_coarse=400, max_levels=12,
                    presmoother=("jacobi", {"omega": 4.0 / 3.0}),
                    postsmoother=("jacobi", {"omega": 4.0 / 3.0}),
                    improve_candidates_iters=0,
                    mixed_precision=False, lane_align=False):
    """Build an SA hierarchy ON DEVICE for a grid-stencil operator.

    Parameters mirror `smoothed_aggregation_solver` where they apply;
    `grid` is the row-major grid shape of the unknowns (required — it is
    what makes the gather-free structured path possible).  Smoothers:
    'jacobi', 'richardson', or 'chebyshev' specs (rho estimates come
    from on-device power iteration).

    ``stride=3`` is the stable choice and the default: the smoothed-P
    span (tentative ±1 cell + one Jacobi smoothing pass ±1 cell = ±2)
    stays strictly inside one aggregate radius, so the Galerkin coarse
    stencil is 3^d-point at EVERY level.  Measured: stride 2 lets the
    coarse stencil grow without bound (25-point, then more) and
    compile/solve cost blows up with it.

    ``improve_candidates_iters`` (default 0 = off) relaxes A z = 0 on
    the candidate before fitting each level's tentative — the host
    ``improve_candidates`` analog ([R] pyamg/aggregation/aggregation.py
    default).  Essential when the near-nullspace is not representable by
    B (diagonally rescaled operators: measured 64² rescaled Poisson 60
    -> 20 CG iters with 8 sweeps); off by default so the ones-candidate
    pipeline stays golden-reproducible.

    ``stride`` may also be a per-dim tuple (SEMICOARSENING: stride 1 in
    weak-coupling dims — the classic cure for grid-aligned anisotropy)
    or ``'auto'``, which reads per-dim coupling strengths off the
    stencil (mean |A[i, i±e_d]|) and coarsens only dims within 9x of
    the strongest, rescaling couplings by 1/stride^2 per level (the
    1/h^2 law).  Reference counterpart: strength-of-connection-guided
    aggregation ([R] pyamg/strength.py + aggregate.py, SURVEY.md §2.3)
    — the structured analog of dropping weak connections.

    Returns a :class:`StructuredDeviceSolver` (drop-in
    DeviceMultilevelSolver).  See module docstring for scope.
    """
    if jnp.dtype(dtype).itemsize == 8:
        jax.config.update("jax_enable_x64", True)   # else silent f32
    if grid is None:
        if not (sp.issparse(A) or isinstance(A, np.ndarray)):
            raise ValueError("grid= is required for DIAMatrix inputs")
        try:
            grid = detect_grid(A)
        except ValueError:
            # not a grid stencil: route to the UNSTRUCTURED device
            # pipeline (round 4 — windowed operators, MIS-2 aggregation,
            # chain-probed RAP; engine/unstructured_setup.py).  Raises
            # ValueError itself when the operator is not windowable
            # either (caller falls back to host setup).
            from .unstructured_setup import device_unstructured_sa_setup
            return device_unstructured_sa_setup(
                A, B=B, dtype=dtype, omega=omega, max_coarse=max_coarse,
                max_levels=max_levels, presmoother=presmoother,
                postsmoother=postsmoother,
                improve_candidates_iters=improve_candidates_iters)
    grid = tuple(int(g) for g in grid)
    dim = len(grid)
    n = int(np.prod(grid))
    if sp.issparse(A) or isinstance(A, np.ndarray):
        if A.shape[0] != n:
            raise ValueError(f"grid {grid} does not match A {A.shape}")
        A_dia = dia_from_scipy(sp.csr_matrix(A), dtype=dtype, row_pad=1)
    elif isinstance(A, DIAMatrix):
        A_dia = A
    else:
        raise TypeError("A must be scipy sparse or DIAMatrix")

    # per-dim coupling strengths for stride='auto' (semicoarsening):
    # mean |A[i, i±e_d]| per dim, updated /9 per 3x-coarsened dim (the
    # 1/h^2 scaling of grid-aligned diffusion stencils)
    couple = None
    if stride == "auto":
        couple = []
        offs = dict(zip(A_dia.offsets, range(len(A_dia.offsets))))
        for d in range(dim):
            delta = int(np.prod(grid[d + 1:]))
            s_d = 0.0
            for o in (delta, -delta):
                if o in offs:
                    s_d = max(s_d, float(jnp.mean(jnp.abs(
                        A_dia.data[offs[o]]))))
            couple.append(s_d)
        if max(couple) == 0:
            couple = None      # degenerate (diagonal) — isotropic plan

    def _level_strides(cpl):
        if cpl is None:
            return _tup(3 if stride == "auto" else stride, dim)
        smax = max(cpl)
        return tuple(3 if c * 9.0 >= smax else 1 for c in cpl)

    # ---- static coarsening plan ---------------------------------------
    # Offset->coordinate decomposition is unambiguous only while every
    # padded dim >= 3*stride (entry spans stay < dim/2); stop coarsening
    # below that (the level is coarse enough for the dense solve anyway).
    plan = []
    cur_grid = grid
    cur_couple = couple
    while int(np.prod(cur_grid)) > max_coarse and len(plan) < max_levels - 1:
        strides = _level_strides(cur_couple)
        grid_p = _padded_grid(cur_grid, strides, lane_align=lane_align)
        if not all(gp >= 3 * s for gp, s in zip(grid_p, strides)
                   if s > 1):
            break
        plan.append((cur_grid, grid_p, strides))
        cur_grid = tuple(g // s for g, s in zip(grid_p, strides))
        if cur_couple is not None:
            cur_couple = [c / (s * s) for c, s in zip(cur_couple,
                                                      strides)]
    nlev = len(plan)
    if nlev == 0:
        raise ValueError(
            f"grid {grid} is below the coarsening threshold "
            f"(max_coarse={max_coarse}); use the host setup path")

    pre_key = _spec_key(presmoother)
    post_key = _spec_key(postsmoother)

    # ---- one fused device program for the whole setup -----------------
    B_dev = None
    if B is not None:
        B_arr = (B if isinstance(B, jnp.ndarray)
                 else jnp.asarray(np.asarray(B).ravel(), dtype=dtype))
        if B_arr.ndim != 1 or B_arr.shape[0] < n:
            raise ValueError("B must be a length-n near-nullspace "
                             "candidate (multi-candidate: use "
                             "device_sa_setup_block)")
        B_dev = B_arr
    out_levels, Ac_dense, coarse_inv = _setup_pipeline(
        A_dia, B_dev, plan=tuple(plan), omega=omega, dtype=dtype,
        pre_key=pre_key, post_key=post_key,
        improve_iters=int(improve_candidates_iters))

    # ---- assemble the DeviceHierarchy (host bookkeeping only) ---------
    dev_levels = []
    infos = []
    for i, ((lv_grid, grid_p, strides), (A_p, S_op, St_op, tv, rho,
                                         pre_arr, post_arr)) in enumerate(
            zip(plan, out_levels)):
        centers = tuple(s // 2 for s in strides)
        coarse_grid = tuple(g // s for g, s in zip(grid_p, strides))
        coarse_grid_p = (plan[i + 1][1] if i + 1 < nlev else coarse_grid)
        P = StructuredProlongator(
            S=S_op, tv=tv, fine_grid_p=grid_p, coarse_grid=coarse_grid,
            coarse_grid_p=coarse_grid_p, stride=strides, center=centers)
        R = StructuredRestrictor(
            St=St_op, tv=tv, fine_grid_p=grid_p, coarse_grid=coarse_grid,
            coarse_grid_p=coarse_grid_p, stride=strides, center=centers)
        pre = _smoother_wrap(pre_key, pre_arr)
        post = _smoother_wrap(post_key, post_arr)
        npad_lvl = int(np.prod(grid_p))
        dev_levels.append(DeviceLevel(
            A=A_p, P=P, R=R, pre=pre, post=post, n=npad_lvl,
            n_pad=int(A_p.n_pad)))
        # rho stays a DEVICE scalar — float() it lazily if you need it
        infos.append({"level": i, "n": npad_lvl, "strides": strides,
                      "ndiags": A_p.ndiags, "rho_D_inv_A": rho})

    nc = int(np.prod(cur_grid))
    nc_pad = nc
    ident = device_relaxation.identity()
    from ..sparse.dia import DenseOperator

    Ac_op = DenseOperator(data=Ac_dense, shape=(nc, nc), nnz=nc * nc)
    dev_levels.append(DeviceLevel(A=Ac_op, P=None, R=None, pre=ident,
                                  post=ident, n=nc, n_pad=nc_pad))

    A64 = None
    if mixed_precision:
        jax.config.update("jax_enable_x64", True)
        grid_p0 = plan[0][1]
        A64_dia = dia_from_scipy(sp.csr_matrix(A), dtype=jnp.float64,
                                 row_pad=1)
        A64 = _relayout_jit(A64_dia, grid=grid, grid_p=grid_p0)

    hier = DeviceHierarchy(levels=dev_levels, coarse_inv=coarse_inv,
                           nc=nc, nc_pad=nc_pad, dtype=dtype, A64=A64)
    return StructuredDeviceSolver(
        hier, grid, plan[0][1],
        setup_info={"levels": infos, "nlevels": nlev + 1})


@partial(jax.jit, static_argnames=("grid", "grid_p"))
def _relayout_jit(A_in, *, grid, grid_p):
    return _relayout_dia(A_in, grid, grid_p)


def device_adaptive_sa_setup(A, grid=None, stages=2, candidate_iters=8,
                             cycle_iters=6, seed=0, dtype=jnp.float32,
                             **kwargs):
    """Adaptive (alpha-SA) hierarchy construction ON DEVICE.

    The device analog of the reference's staged adaptive setup
    ([R] pyamg/aggregation/adaptive.py::initial_setup_stage /
    general_setup_stage, SURVEY.md §2.2):

    - stage 0 (initial): relax B = ones on the homogeneous system
      A z = 0 (``candidate_iters`` weighted-Jacobi sweeps, on device)
      and build the single-candidate structured hierarchy from it (the
      pipeline improves it per level as well);
    - each further stage (general): expose remaining algebraically-
      smooth error by running ``cycle_iters`` V-cycles on A z = 0 from
      a hashed-random start with the CURRENT hierarchy — what survives
      is exactly the error the hierarchy cannot remove — orthogonalize
      it against the existing candidates, and rebuild with the grown
      candidate block through the multi-candidate pipeline
      (:func:`pyamg_tpu.engine.block_setup.device_sa_setup_block`).
      Replacing the single candidate instead of ACCUMULATING was
      measured worse than no adaptivity (round 3) — the reference
      grows num_candidates for the same reason.

    Everything stays device-resident (candidates never leave the
    chip).  ``stages`` <= 4 (the block pipeline's candidate cap).
    Returns the final device solver; ``kwargs`` pass through to the
    setup calls (which accept grid/stride/max_coarse/... in common).
    """
    from .block_setup import device_sa_setup_block

    if not 1 <= int(stages) <= 4:
        raise ValueError("stages must be in 1..4 (block candidate cap)")
    # an explicit improve_candidates_iters kwarg overrides candidate_iters
    # for the in-pipeline improvement (and must not collide below)
    improve = int(kwargs.pop("improve_candidates_iters", candidate_iters))
    # an initial candidate (the reference's initial_candidates) seeds
    # stage 0 in place of ones
    B0 = kwargs.pop("B", None)
    A_csr = sp.csr_matrix(A)
    if grid is None:
        grid = detect_grid(A_csr)
    n = A_csr.shape[0]
    A_dia = dia_from_scipy(A_csr, dtype=dtype, row_pad=1)
    diag = A_dia.diagonal()
    dinv = jnp.where(diag != 0, 1.0 / jnp.where(diag != 0, diag, 1), 0)
    rho = _power_rho(A_dia, dinv)

    z_init = (jnp.ones(n, dtype=dtype) if B0 is None
              else jnp.asarray(np.asarray(B0).ravel()[:n], dtype=dtype))

    @jax.jit
    def _relax_init(A_dia, diag, dinv, rho, z):
        # everything device-resident flows as a jit ARGUMENT (closure
        # constants re-upload per call on this backend, CLAUDE.md rule 2)
        z = jnp.where(diag != 0, z, 0)
        om = 1.0 / jnp.maximum(rho, 1e-30)
        for _ in range(int(candidate_iters)):
            z = z - om * (dinv * (A_dia @ z))
        return z / jnp.maximum(jnp.max(jnp.abs(z)), 1e-30)

    cands = [_relax_init(A_dia, diag, dinv, rho, z_init)]
    dsa = device_sa_setup(A_csr, grid=grid, B=cands[0], dtype=dtype,
                          improve_candidates_iters=improve, **kwargs)
    for s in range(1, int(stages)):
        z0 = (_hash_weights(n, 9876 + int(seed) + s).astype(dtype)
              - jnp.asarray(0.5, dtype=dtype))
        z = dsa.solve(np.zeros(n), x0=z0, tol=0.0,
                      maxiter=int(cycle_iters), accel=None,
                      device_out=True)
        # orthogonalize against the accumulated candidates (the
        # reference's general_setup_stage projection) and normalize
        for c in cands:
            denom = jnp.maximum(jnp.sum(c * c), 1e-30)
            z = z - (jnp.sum(c * z) / denom) * c
        zmax = float(jnp.max(jnp.abs(z)))
        if zmax < 1e-10:
            # degenerate-candidate guard (ADVICE r3 / reference
            # adaptive.py analog): the current hierarchy fully removed
            # the probe error, or orthogonalization annihilated z — an
            # (effectively) zero candidate would feed a rank-deficient
            # tentative fit (NaNs); keep the previous solver.  The probe
            # starts at O(1) magnitude, so 1e-10 is a relative floor.
            break
        z = z / zmax
        cands.append(z)
        Bstack = jnp.stack(cands, axis=1)
        dsa = device_sa_setup_block(
            A_csr, grid=grid, B=Bstack, dtype=dtype,
            **{k: v for k, v in kwargs.items()
               if k in ("stride", "max_coarse", "max_levels", "omega",
                        "presmoother", "postsmoother",
                        "mixed_precision")})
    return dsa
