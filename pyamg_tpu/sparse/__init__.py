"""Device sparse containers and their SpMV forms (SURVEY.md §7 step 1)."""

from .dia import (DenseOperator, DIAMatrix, dense_from_scipy,
                  dia_from_scipy, dia_from_stencil, dia_spgemm)
from .block_dia import BlockDIAMatrix, block_dia_from_scipy
from .window import (ComplexWindowed,
                     TransposedWindowed, WindowedELL,
                     complex_windowed_from_scipy, windowed_from_scipy)
from .formats import (
    BlockELLMatrix,
    ELLMatrix,
    bsr_ell_from_scipy,
    ell_from_scipy,
    ell_to_scipy,
    pad_to,
    pad_vector,
)


def select_operator(A, dtype=None, row_pad=8, dense_threshold=2048,
                    max_diags=600):
    """Pick the device format for a scipy operator.

    - small (either dim <= dense_threshold): DenseOperator
    - square banded (<= max_diags distinct diagonals): DIAMatrix
      (shifted-slice SpMV — the gather-free hot path)
    - otherwise: WindowedELL when its row blocks have narrow column
      windows, else plain gather ELL
    """
    import jax.numpy as jnp

    if dtype is None:
        dtype = jnp.float32
    n, m = A.shape
    if max(n, m) <= dense_threshold:
        return dense_from_scipy(A, dtype=dtype, row_pad=row_pad)
    if n == m:
        dia = dia_from_scipy(A, dtype=dtype, row_pad=row_pad,
                             max_diags=max_diags)
        if dia is not None:
            return dia
    if jnp.issubdtype(jnp.dtype(dtype), jnp.complexfloating):
        # complex windowed operators take the re/im-split form
        win = complex_windowed_from_scipy(A, dtype=dtype)
    else:
        win = windowed_from_scipy(A, dtype=dtype)
    if win is not None:
        return win
    return ell_from_scipy(A, dtype=dtype, row_pad=row_pad)


__all__ = [
    "BlockDIAMatrix",
    "BlockELLMatrix",
    "ComplexWindowed",
    "block_dia_from_scipy",
    "complex_windowed_from_scipy",
    "DenseOperator",
    "DIAMatrix",
    "ELLMatrix",
    "bsr_ell_from_scipy",
    "dense_from_scipy",
    "dia_from_scipy",
    "dia_from_stencil",
    "dia_spgemm",
    "ell_from_scipy",
    "ell_to_scipy",
    "pad_to",
    "pad_vector",
    "select_operator",
]
