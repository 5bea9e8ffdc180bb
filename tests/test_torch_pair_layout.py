"""What surrounds the pair kernels K2 and K4 in Python, on the CPU: their
launch shape (`pair_launch_shape`) and the squared thresholds they test
(`square_within`).  The kernels themselves are held to their plain versions
on the card by tests/test_torch_kernels_cuda.py.
"""
from __future__ import annotations

import math

import numpy as np
import pytest

from quadswarm_tpu_torch.ops.kernels import swarm_interactions as si

FLEETS = [(1, 1), (1, 2), (3, 150), (3, 200), (3, 300), (256, 128),
          (1024, 8), (4, 2048), (2111, 1), (132, 16), (1, 2048)]


@pytest.mark.parametrize("history", [True, False], ids=["K2", "K4"])
@pytest.mark.parametrize("e,n", FLEETS)
def test_pair_launch_shape_covers_every_row_once(e, n, history):
    shape = si.pair_launch_shape(e, n, history)
    rows = shape.rows
    # a power of two: whole warps of rows, or warps of 32 / rows slices
    assert rows & (rows - 1) == 0 and (rows % 32 == 0 or 32 % rows == 0)
    assert shape.threads == rows * shape.slices
    # consecutive tiles of `rows` rows: every row of every env exactly once
    covered = np.zeros(e * n, np.int64)
    for b in range(shape.blocks):
        first, stop = b * rows, min((b + 1) * rows, e * n)
        assert first < stop, "an empty block"
        covered[first:stop] += 1
        # the envs a block stages fit its shared memory
        assert (stop - 1) // n - first // n + 1 <= shape.span
    assert (covered == 1).all()


@pytest.mark.parametrize("history", [True, False], ids=["K2", "K4"])
@pytest.mark.parametrize("e,n", FLEETS)
def test_pair_launch_shape_fits_a_hopper_block(e, n, history):
    shape = si.pair_launch_shape(e, n, history)
    assert shape.threads <= 512                 # the kernels' bound
    assert shape.shared_bytes <= si.SHARED_BYTES_MAX
    words = math.ceil(n / si.PACK_BITS)
    assert 1 <= shape.slices <= words
    # a row's slices are runs of whole words that cover its columns once
    per = math.ceil(words / shape.slices)
    seen = [w for s in range(shape.slices)
            for w in range(s * per, min((s + 1) * per, words))]
    assert seen == list(range(words))
    assert per <= si.PAIR_WORDS_PER_THREAD or \
        shape.slices == si.PAIR_MAX_SLICES


def test_pair_launch_shape_fills_the_card_at_the_swarm_shape():
    for history in (True, False):
        shape = si.pair_launch_shape(256, 128, history)
        assert shape.blocks >= 132                  # an H100's SMs
        assert shape.span == 1                      # each env staged once
    assert si.pair_launch_shape(4, 2048).blocks >= 132


@pytest.mark.parametrize("rows,slices", [(32, 1), (64, 2), (96, 3), (32, 5),
                                         (1, 3), (2, 10)])
def test_pair_shape_counts_blocks_and_shared_bytes(rows, slices):
    e, n = 3, 150
    shape = si.pair_shape(e, n, rows, slices)
    assert shape.blocks == math.ceil(e * n / rows)
    live = math.ceil(n / 16)
    planes = 4 * 3 * shape.span * 16 * live
    row_words = 4 * rows * (live | 1)      # odd stride: no bank conflicts

    def parts(head):                       # 16-byte parts, 16-byte aligned
        if slices == 1:
            return head
        return math.ceil((head + row_words) / 16) * 16 \
            + 16 * (slices - 1) * rows
    assert shape.shared_bytes == parts(planes + row_words)
    k4 = si.pair_shape(e, n, rows, slices, history=False)
    assert k4.shared_bytes == parts(planes)


ARM = 0.046


@pytest.mark.parametrize("radius", [0.35, 1.0, 2 * ARM, 4 * ARM, 1e-3, 0.0,
                                    1e-30, 1.0e19, float("inf")])
def test_square_within_decides_as_the_root_does(radius):
    r = np.float32(radius)
    t = np.float32(si.square_within(radius))
    assert np.sqrt(t) <= r
    if np.isfinite(t):
        assert not np.sqrt(np.nextafter(t, np.float32(np.inf))) <= r
    # squares about the threshold and about r * r: the root decides alike
    rng = np.random.default_rng(0)
    centre = np.float32(min(float(r) * float(r), 3.0e38))
    s = np.concatenate([
        centre * (1 + rng.uniform(-1e-6, 1e-6, 4000)).astype(np.float32),
        t + np.arange(-50, 51, dtype=np.float32) * np.spacing(t),
        rng.uniform(0, 4, 1000).astype(np.float32)]).astype(np.float32)
    s = s[np.isfinite(s) & (s >= 0)]
    assert np.array_equal(np.sqrt(s) <= r, s <= t)


def test_square_within_of_a_negative_or_nan_radius_admits_nothing():
    assert si.square_within(-1.0) < 0
    assert si.square_within(float("nan")) < 0


def test_squared_thresholds_give_the_masks_of_the_roots():
    """On a dense cloud, squared distances summed as the plain version sums
    them: s <= square_within(h) is d <= h for every pair."""
    rng = np.random.default_rng(1)
    pos = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    d = pos[None, :, :] - pos[:, None, :]
    sq = d * d
    s = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    dist = np.sqrt(s)                     # correctly rounded, as on the card
    for h in (0.35, 1.0, float(np.float32(dist[3, 7]))):
        assert np.array_equal(dist <= np.float32(h),
                              s <= np.float32(si.square_within(h)))
