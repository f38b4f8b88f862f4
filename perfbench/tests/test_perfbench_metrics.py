"""The frozen metric arithmetic: percentiles over all samples, waits
counted at the window's end, rates over the window, and the FLOP and byte
counts against hand-worked ones at one shape of each configuration."""
import json

import numpy as np
import pytest

import flops
from bench import stats
from conftest import HERE


def _shape(name):
    return flops.Shape.of(json.loads(
        (HERE / "configs" / f"{name}.json").read_text()))


def test_percentile_is_numpys_linear_one_over_all_samples():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 200, 1001):
        x = rng.exponential(size=n)
        for q in (0, 50, 95, 99, 100):
            assert stats.percentile(x, q) == pytest.approx(
                np.percentile(x, q), rel=1e-12)
    assert stats.percentile([], 95) is None


def test_a_request_still_waiting_counts_its_wait_so_far():
    due = [0.0, 1.0, 2.0, 9.5, 10.5]
    first = [0.5, None, 2.25, 11.0, None]
    # the one due after the window's end is not the window's
    assert stats.ttft_samples(due, first, 10.0) == [0.5, 9.0, 0.25, 0.5]


def test_gaps_and_counts_take_what_falls_in_the_window():
    stamps = [0.0, 1.0, 1.0, 2.5, 4.0, 11.0]
    assert stats.gaps_in_window(stamps, 1.0, 10.0) == [1.0, 0.0, 1.5, 1.5]
    assert stats.count_in_window(stamps, 1.0, 10.0) == 4
    assert stats.rate(300, 30.0) == 10.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_visible_lines_against_counting_them():
    for length, offset, window in ((10, 0, 4), (10, 3, 4), (7, 20, 5),
                                   (2300, 0, 4096), (100, 4000, 4096),
                                   (33, 5, 0)):
        brute = sum(min(p + 1, window) if window else p + 1
                    for p in range(offset, offset + length))
        assert flops.visible(length, offset, window) == brute
    assert flops.visible(10, 0, 4) == 1 + 2 + 3 + 7 * 4


def test_starcoder2_counts_by_hand():
    s = _shape("starcoder2-3b")
    assert flops.layer_params(s) == 95_944_704
    assert flops.layer_params(s) * 30 + flops.head_params(s) \
        == 3_029_336_064                      # 3.03 B, as published
    # a 2,000-token prompt: 2 x 2,000 x 2,001 / 2 pairs a head and layer
    assert flops.prefill_model_flops(s, 2000) == 12_251_315_109_888
    f, b = flops.flash_work(s, 2000)
    assert (f, b) == (737_648_640_000, 798_720_000)
    assert flops.bound_s(f, b) == pytest.approx(f / 989e12)   # compute


def test_minicpm_counts_by_hand():
    s = _shape("minicpm-2b")
    assert flops.layer_params(s) == 61_046_784
    assert flops.head_params(s) == 282_822_912     # tied, used as the head
    assert flops.decode_model_flops(s, 1000, 1) == 5_818_397_184
    f, b = flops.paged_decode_work(s, 1001)
    # a cached line is 40 x 2 x 36 x 64 x 2 = 368,640 bytes
    assert (f, b) == (369_008_640, 1001 * 368_640 + 368_640)
    assert flops.bound_s(f, b) == pytest.approx(b / 3.35e12)  # memory


def test_the_published_peaks():
    assert flops.PEAK_BF16_FLOPS == 989e12
    assert flops.PEAK_HBM_BYTES == 3.35e12
    assert flops.bound_s(989e12, 0) == 1.0
    assert flops.bound_s(0, 3.35e12) == 1.0


def test_the_knee_sweep_tells_growth_from_swing():
    import sweep
    steady = [30, 42, 25, 38, 29, 44, 31, 27, 40, 33, 26, 39] * 5
    assert not sweep.grows(steady)
    # a count that climbs by a third of its mean over the window grows
    climbing = [20 + k * 0.25 for k in range(60)]
    assert sweep.grows(climbing)
    # a few requests never count as growth
    assert not sweep.grows([1] * 20 + [2] * 20 + [3] * 20)
    rows = [{"rate": r, "grows": g} for r, g in (
        (1.0, False), (1.0, False), (1.0, True),
        (1.5, False), (1.5, True), (1.5, False),
        (2.0, True), (2.0, True), (2.0, False))]
    assert sweep.knee(rows) == 1.5
    with pytest.raises(RuntimeError):
        sweep.knee([{"rate": 1.0, "grows": True}] * 3)
