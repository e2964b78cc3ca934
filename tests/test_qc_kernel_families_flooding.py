"""QC decode kernel (Pallas interpreter) against ops.spa across the
standardized families, flooding schedule (cases in qc_family_cases.py)."""

import pytest

from qc_family_cases import cases, check_kernel_matches_plain_decoder


@pytest.mark.parametrize("name,snr,variant", cases("flooding"))
def test_kernel_matches_plain_decoder(name, snr, variant):
    check_kernel_matches_plain_decoder(name, snr, "flooding", variant)
