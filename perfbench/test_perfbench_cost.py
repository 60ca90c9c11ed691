"""The cost model's counts at small shapes, counted by hand."""
import pytest

from perfbench import cost


def test_peaks_are_the_h100_sxm_data_sheets():
    assert cost.least_s(3.35e12) == pytest.approx(1.0)
    assert cost.least_s(0.0, 67e12) == pytest.approx(1.0)
    assert cost.least_s(0.0, 0.0, 34e12) == pytest.approx(1.0)
    # the larger of bytes and operations, operations of both kinds summed
    assert cost.least_s(3.35e12, 67e12, 34e12) == pytest.approx(2.0)


@pytest.mark.parametrize("shape,want", [
    # x 2*3*4, y and w 2*3 each, grid and errors 2*4*5 each, 4 bytes
    ((2, 3, 4, 5, 7), (4 * (24 + 12 + 80), 2 * 120, 7)),
    ((1, 8, 48, 16, 0), (4 * (384 + 16 + 1536), 2 * 6144, 0)),
])
def test_stump_scan_batched(shape, want):
    assert cost.stump_scan_batched(*shape) == want


@pytest.mark.parametrize("shape,want", [
    # xsel 2*3*4 and the three (2,3) rows read, (2,4) written
    ((2, 3, 4), (96 + 72 + 32, 144)),
    ((8, 64, 1), (4 * 512 + 12 * 512 + 32, 3072)),
])
def test_stump_vote_batched(shape, want):
    assert cost.stump_vote_batched(*shape) == want


def test_local_round_and_sync():
    # x 24, y, D read and D written 3 * 6, grid 20, picks 2 * 4: 70 floats
    assert cost.local_round(2, 3, 4, 5, 7) == pytest.approx(
        max(280 / 3.35e12, 240 / 67e12 + 7 / 34e12))
    # x 30, xv 40, y/D/D' 18, yv/vm/vm' 24, 6 stumps in and out: 172 floats;
    # 6 operations on 2 clients' 6 stumps over 3 rows and twice 4
    assert cost.sync(2, 3, 4, 5, 6) == pytest.approx(
        max(688 / 3.35e12, 792 / 67e12))
