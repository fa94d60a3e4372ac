"""The roofline arithmetic reproduces `PERF.md`'s kernel-table bounds at
chip_smoke.py's shapes (N = 200 landmarks, 3 levels, S = 8 sequences)."""
import pytest
import torch

from slambench import roofline


def test_k3_bound():
    ms, by = roofline.bound_ms(roofline.k3_bytes(200), roofline.k3_flops(200, [14]))
    assert by == "bytes" and ms == pytest.approx(0.000267, abs=5e-7)


def test_k4_bound():
    ms, by = roofline.bound_ms(roofline.k4_bytes(200), 0)
    assert by == "bytes" and ms == pytest.approx(0.000294, abs=5e-7)


def test_k8_bound():
    ms, by = roofline.bound_ms(roofline.k8_bytes(8, 200), roofline.k8_flops(200, [9] * 8))
    assert by == "operations" and ms == pytest.approx(0.0000577, abs=5e-8)


def test_gather_bytes_counts_covered_pixels_once():
    img = torch.zeros((10, 10))
    xi, yi = torch.tensor([0, 2, 8]), torch.tensor([0, 0, 8])
    # Windows of 4: [0,4)x[0,4) and [0,4)x[2,6) overlap on 8 pixels; the
    # third covers 2x2 inside the image.
    n = roofline.gather_bytes([(img, xi, yi, 4)])
    assert n == 3 * (16 * 4 + 8) + 4 * (16 + 8 + 4)


def test_fleet_step_is_bounded_by_its_frames():
    nbytes, flops = roofline.fleet_step(16, 200, (480, 640), 3)
    assert nbytes > 16 * 480 * 640 * 4
    ms, by = roofline.bound_ms(nbytes, flops)
    assert by == "bytes" and 0.005 < ms < 0.01
