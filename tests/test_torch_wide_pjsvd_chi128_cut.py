"""`pjsvd` at [512, 256] on the families with a cut spectrum: half the
singular values 1e-6 or zero (`tests/test_torch_wide_pjsvd_chi128.py` has
the graded ones)."""

import pytest

from torch_wide_cases import check_family

CUT = ("rankcut", "clusters")


@pytest.mark.parametrize("family", CUT)
def test_pjsvd_chi128_cut_accuracy(family):
    check_family(512, 256, family, CUT)
