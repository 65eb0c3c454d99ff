"""Native (C++) setup-phase kernels.

Analog of [R] pyamg/amg_core/ (SURVEY.md §2.4): the
serial-semantics hot loops of the *setup* phase (RS splitting, greedy
aggregation, sequential relaxation sweeps, two-pass interpolation) are
implemented in C++ (amg_core.cpp), compiled on demand with g++ and bound
via ctypes.  The *solve* phase never touches this module — it runs as
jitted XLA code on device.

Importing names from this package returns the native function when the
extension is available and raises ImportError otherwise; callers keep
vectorized NumPy fallbacks.
"""

from __future__ import annotations

from ._loader import get_native

_native = get_native()

if _native is not None:
    from ._loader import NATIVE_EXPORTS as _exports

    globals().update({name: getattr(_native, name) for name in _exports})
    __all__ = list(_exports)
    AVAILABLE = True
else:
    __all__ = []
    AVAILABLE = False
