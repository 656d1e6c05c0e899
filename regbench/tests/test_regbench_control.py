"""The control of ``correct`` (``regbench/control.py``: the reference one
precision below, TF32) fails every cell's limits, here at a tenth of the
cells' rows on the CPU; on the card at the cells' own size by
``python3 -m regbench.control``."""

from __future__ import annotations

import pytest

from conftest import CELLS, SEED
from regbench import check, control


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits(small_cell, name):
    cell = small_cell(name, step=4)
    got = control.readings(cell, SEED, "cpu", requests=2)
    assert check.fails(got, cell.limits), got
