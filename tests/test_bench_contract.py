"""Driver-contract guards for bench.py.

The driver records only a 2,000-char tail of bench output and parses the
final JSON line.  These tests pin the contract pieces that need no GPU:
the line-length guard, that the worst-case contract line stays under the
limit, and that an unknown device has no peak bandwidth.
"""
import json
import os
import sys

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, ROOT)

import bench  # noqa: E402


def test_contract_line_guard_rejects_oversize():
    ok = json.dumps({"metric": "m", "value": 1.0})
    assert bench.check_contract_line(ok) == ok
    with pytest.raises(ValueError):
        bench.check_contract_line("x" * bench.CONTRACT_LINE_LIMIT)


def test_committed_headline_fits_capture_window():
    """The headline record with every section failing on a long error
    (the largest the line can get) must stay under the driver's capture
    window."""
    err = {"error": "RuntimeError: " + "x" * 5000}
    rec = {"bs": 64, "dim": 57210, "nnz_per_s": 1.23456789e11,
           "achieved_GBps": 1234.5678, "roofline_frac": 0.123456789,
           "rel_err_vs_host": 1.234567e-7}
    for large, small in ((rec, rec), (err, err)):
        result = bench.headline("NVIDIA H100 80GB HBM3", large, small,
                                123.456789, err, err)
        line = json.dumps(result)
        assert len(line) < bench.CONTRACT_LINE_LIMIT, len(line)
        assert bench.check_contract_line(line) == line


def test_unknown_device_has_no_peak():
    assert bench.peak_hbm_bw("NVIDIA H100 80GB HBM3") == 3.35e12
    with pytest.raises(KeyError):
        bench.peak_hbm_bw("cpu")
