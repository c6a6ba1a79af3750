"""The MFU script's peak table: keyed by device_kind, unknown is an error."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))

import mesmer_mfu  # noqa: E402


def test_h100_peak_is_the_data_sheet_bf16_rate():
    assert mesmer_mfu.peak_tflops("NVIDIA H100 80GB HBM3") == 989.0


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_unknown_device_is_an_error(kind):
    with pytest.raises(KeyError):
        mesmer_mfu.peak_tflops(kind)
