"""pyamg_tpu — an algebraic multigrid framework in JAX for the GPU.

A from-scratch rebuild of the capability surface of the reference AMG
library (ben-s-southworth/pyamg; see SURVEY.md) with its solve phase on
an accelerator:

- **setup phase** (hierarchy construction) runs as vectorized host passes
  (NumPy/SciPy + the C++ amg_core extension for serial-semantics
  algorithms), exactly reproducing the reference's numerics;
- **solve phase** (cycling + Krylov) compiles to a single jitted XLA
  program over a static level pytree — DIA, block-DIA, windowed-ELL and
  dense operators in plain XLA, lax.while_loop Krylov — via
  :mod:`pyamg_tpu.engine`;
- **distribution** uses jax.sharding Mesh row partitions with halo
  exchange collectives via :mod:`pyamg_tpu.parallel`.

Public API mirrors the reference's top-level re-exports
([R] pyamg/__init__.py, SURVEY.md §1).
"""

from . import blackbox, gallery
from .aggregation import (
    adaptive_sa_solver,
    pairwise_solver,
    rootnode_solver,
    smoothed_aggregation_solver,
)
from .blackbox import solve, solver, solver_configuration
from .classical import air_solver, ruge_stuben_solver
from .gallery import demo
from .multilevel import MultilevelSolver, coarse_grid_solver, multilevel_solver
from .strength import (
    classical_strength_of_connection,
    symmetric_strength_of_connection,
)

from .version import version as __version__

__all__ = [
    "__version__",
    "gallery",
    "demo",
    "smoothed_aggregation_solver",
    "rootnode_solver",
    "adaptive_sa_solver",
    "pairwise_solver",
    "ruge_stuben_solver",
    "air_solver",
    "blackbox",
    "solve",
    "solver",
    "solver_configuration",
    "MultilevelSolver",
    "multilevel_solver",
    "coarse_grid_solver",
    "classical_strength_of_connection",
    "symmetric_strength_of_connection",
]


def test():  # pragma: no cover
    """Run the test suite (reference parity: pyamg.test())."""
    import pytest

    return pytest.main(["-q", "tests/"])


def show_config():  # pragma: no cover
    """Print backend/runtime diagnostics (JAX backend and devices,
    amg_core)."""
    import numpy as _np
    import scipy as _sp

    from . import amg_core as _core

    print(f"pyamg_tpu {__version__}")
    print(f"  numpy {_np.__version__}, scipy {_sp.__version__}")
    print(f"  native amg_core: {_core.AVAILABLE}")
    try:
        import jax as _jax

        dev = _jax.devices()[0]
        print(f"  jax {_jax.__version__}, platform {dev.platform}, "
              f"{dev.device_kind}, devices {_jax.device_count()}")
    except Exception as exc:  # noqa: BLE001
        print(f"  jax unavailable: {exc}")
