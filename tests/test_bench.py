"""bench.py's device contract: no GPU is an error, and so is a GPU whose
device_kind has no row in the peak table (never a default)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def test_device_info_refuses_cpu():
    with pytest.raises(RuntimeError, match="measures the GPU"):
        bench.device_info()


def test_peaks_known_and_unknown_kinds():
    h100 = bench.peaks("NVIDIA H100 80GB HBM3")
    assert h100["tf32_flops"] == 495e12 and h100["hbm_bytes"] == 3.35e12
    with pytest.raises(KeyError, match="no published peaks"):
        bench.peaks("Unknown Accelerator X")
