"""`pjsvd` past n = 128 on the CPU: the saturated chi = 96 theta shape
[384, 192] through the plain versions of K2 and K1 with the engine's
sweeps (`tests/torch_wide_cases.py`); `tests/test_torch_wide_pjsvd_chi128.py`
runs the chi = 128 shape [512, 256] through the same checks."""

import pytest

from torch_wide_cases import FAMILIES, check_family


@pytest.mark.parametrize("family", FAMILIES)
def test_pjsvd_wide_graded_accuracy(family):
    check_family(384, 192, family)
