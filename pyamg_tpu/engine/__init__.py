"""Device solve-phase engine: jitted hierarchies, cycles, Krylov.

See SURVEY.md §7: the solve phase is one jitted XLA program over a static
level pytree.  Build with ``as_device_solver(ml)`` from any host
MultilevelSolver.
"""

from .block_setup import (BlockStructuredProlongator,
                          BlockStructuredRestrictor, device_sa_setup_block)
from .classical_setup import (EmbeddedProlongator, EmbeddedRestrictor,
                              device_air_setup, device_rs_setup)
from .device_setup import (StructuredDeviceSolver, device_adaptive_sa_setup,
                           device_sa_setup)
from .hierarchy import DeviceHierarchy, DeviceLevel, compile_hierarchy
from .krylov import (device_bicgstab, device_cg, device_cgne,
                     device_cgnr, device_cr, device_fgmres, device_gmres,
                     device_minimal_residual, device_steepest_descent)
from .solver import DeviceMultilevelSolver, as_device_solver
from .unstructured_setup import device_unstructured_sa_setup
from .unstructured_classical import (device_unstructured_rs_setup,
                                    device_unstructured_air_setup)

__all__ = [
    "DeviceHierarchy",
    "DeviceLevel",
    "StructuredDeviceSolver",
    "compile_hierarchy",
    "device_bicgstab",
    "device_cg",
    "device_cgne",
    "device_cgnr",
    "device_cr",
    "device_fgmres",
    "device_gmres",
    "device_minimal_residual",
    "device_steepest_descent",
    "device_air_setup",
    "device_rs_setup",
    "device_adaptive_sa_setup",
    "device_sa_setup",
    "device_sa_setup_block",
    "device_unstructured_sa_setup",
    "device_unstructured_rs_setup",
    "device_unstructured_air_setup",
    "EmbeddedProlongator",
    "EmbeddedRestrictor",
    "BlockStructuredProlongator",
    "BlockStructuredRestrictor",
    "DeviceMultilevelSolver",
    "as_device_solver",
]
