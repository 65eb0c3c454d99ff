"""Checks that need a card: chip_smoke.py's phases at real width.

Marked ``gpu``; the ``gpu`` fixture skips them unless JAX's first device
is a GPU (run ``PYAMG_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu`` on
the card).  ``python chip_smoke.py`` runs the same checks and more."""
import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu


def test_operator_parity_real_width(gpu):
    out = cs.phase_operators(2048, measure=False)
    assert set(out) == {"float32", "float64"}


def test_config1_host_built_real_width(gpu):
    res = cs.phase_host_built(2048)
    assert res["true_relres"] <= 1e-8 and res["histories_identical"]


def test_config1_device_built_real_width(gpu):
    res = cs.phase_device_built(2048)
    assert res["true_relres"] <= 1e-8
