"""`pjsvd` at the saturated chi = 128 theta shape [512, 256] on the CPU,
through the checks of `tests/torch_wide_cases.py`: the graded families in
one batch here, the cut ones in `tests/test_torch_wide_pjsvd_chi128_cut.py`
(each file ~20 s alone on one core: 2040 rounds of K2's and 1530 of K1's
plain versions)."""

import pytest

from torch_wide_cases import check_family

GRADED = ("gentle", "wide", "rank16")


@pytest.mark.parametrize("family", GRADED)
def test_pjsvd_chi128_graded_accuracy(family):
    check_family(512, 256, family, GRADED)
