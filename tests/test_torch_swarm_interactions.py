"""The pair kernels' module of the port against the JAX package's.

`quadswarm_tpu_torch/ops/kernels/swarm_interactions.py` (K2 pair collisions
with packed history, K3 k-nearest neighbour observation, K4 interaction
reduction) against `quadswarm_tpu/ops/pallas/swarm_interactions.py`.  The
same clouds, made from a numpy seed, go through both: the JAX side runs its
Pallas kernels in interpret mode, as tests/test_pallas_kernels.py does; the
port, on CPU tensors, runs the plain versions that stand beside its CUDA
kernels.  Masks, partners and packed words must be equal; float outputs
agree within the tolerances of the JAX package's own kernel tests.

The JAX kernels take distances from |a|^2+|b|^2-2ab, the port from
dx^2+dy^2+dz^2, so a pair within an ulp of a threshold could flip a bit.
Every cloud is therefore drawn so that no pair sits within 1e-5 of a
threshold (and no two selection metrics within 1e-4 where K3 picks), and
the tests assert that.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadswarm_tpu.ops.pallas import swarm_interactions as j_si
from quadswarm_tpu_torch.env import collisions as t_coll
from quadswarm_tpu_torch.env import neighbors as t_neighbors
from quadswarm_tpu_torch.env import reward as t_reward
from quadswarm_tpu_torch.ops.kernels import swarm_interactions as t_si

PEN_TOL = dict(rtol=1e-3, atol=1e-3)      # tests/test_pallas_kernels.py
TOPK_TOL = dict(rtol=2e-3, atol=2e-3)     # tests/test_pallas_kernels.py
MARGIN = 1e-5


def _dist64(pos):
    d = pos[..., :, None, :].astype(np.float64) - pos[..., None, :, :]
    return np.sqrt((d * d).sum(-1))


def _threshold_margin(pos, thresholds) -> float:
    """Least |d - threshold| over all pairs of distinct drones."""
    dist = _dist64(pos)
    off = ~np.eye(pos.shape[-2], dtype=bool)
    return min(float(np.abs(dist[..., off] - t).min()) for t in thresholds)


def _cloud(seed, shape, half_width, thresholds):
    """A uniform cloud with no pair within MARGIN of a threshold: the first
    seed from `seed` on that gives one."""
    for s in range(seed, seed + 50):
        pos = np.random.default_rng(s).uniform(
            -half_width, half_width, shape + (3,)).astype(np.float32)
        if _threshold_margin(pos, thresholds) > MARGIN:
            return pos
    raise AssertionError("no cloud with a clear threshold margin")


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --------------------------------------------------------------------------
# Packed pair history
# --------------------------------------------------------------------------

def test_pack_unpack_roundtrip_and_layout_match_jax():
    rng = np.random.default_rng(3)
    pairs = rng.uniform(size=(17, 17)) < 0.3
    pairs &= ~np.eye(17, dtype=bool)
    packed = t_si.pack_pairs(_t(pairs))
    assert packed.shape == (17, t_si.PACK_LANES) and packed.dtype == torch.int32
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(j_si.pack_pairs(jnp.asarray(pairs))))
    np.testing.assert_array_equal(t_si.unpack_pairs(packed, 17).numpy(), pairs)
    np.testing.assert_array_equal(
        np.asarray(j_si.unpack_pairs(jnp.asarray(packed.numpy()), 17)), pairs)
    # bit b of word w is column 16 w + b; 17 columns live in two words
    assert int(packed[5, 1]) == int(pairs[5, 16])
    assert not packed[:, 2:].any() and int(packed.max()) < 1 << 16


def test_pack_constants_match_jax():
    assert (t_si.PACK_BITS, t_si.PACK_LANES) == (j_si.PACK_BITS,
                                                 j_si.PACK_LANES)
    assert t_si.MAX_AGENTS == 2048


@pytest.mark.parametrize("lead", [(), (3,)])
def test_pack_pairs_leading_axes(lead):
    rng = np.random.default_rng(4)
    pairs = rng.uniform(size=lead + (40, 40)) < 0.5
    packed = t_si.pack_pairs(_t(pairs))
    assert packed.shape == lead + (40, t_si.PACK_LANES)
    np.testing.assert_array_equal(t_si.unpack_pairs(packed, 40).numpy(), pairs)


# --------------------------------------------------------------------------
# K2: pair collisions
# --------------------------------------------------------------------------

def _dense_expectation(pos, prev_dense, hitbox):
    """Masks and the response partner from dense tensors, the way the dense
    env route derives them (env/collisions.py)."""
    n = pos.shape[0]
    _, curr = t_coll.collision_matrix(_t(pos), hitbox)
    curr = curr.numpy()
    new = curr & ~prev_dense
    idx = np.arange(n)
    upper = new & (idx[:, None] < idx[None, :])
    any_row, any_col = upper.any(1), upper.any(0)
    active = any_row | any_col
    partner = np.where(any_row, upper.argmax(1), upper.argmax(0))
    return curr, active, np.where(active, partner, 0)


@pytest.fixture(scope="module")
def collision_case():
    """Dense clouds (e=2, n=150) with a jittered previous tick, so that
    new, repeated and ended pairs all occur; both packages' outputs."""
    e, n = 2, 150
    hitbox, falloff, max_pen = 0.35, 1.0, 10.0
    pos = _cloud(2, (e, n), 1.2, (hitbox, falloff))
    for s in range(100, 150):
        jitter = np.random.default_rng(s).normal(0, 0.05, pos.shape)
        pos0 = pos + jitter.astype(np.float32)
        if _threshold_margin(pos0, (hitbox,)) > MARGIN:
            break
    zeros = torch.zeros((e, n, t_si.PACK_LANES), dtype=torch.int32)
    prev = t_si.pair_collisions(_t(pos0), zeros, hitbox, falloff, max_pen)[4]
    got = t_si.pair_collisions(_t(pos), prev, hitbox, falloff, max_pen)
    want = j_si.pair_collisions(jnp.asarray(pos), jnp.asarray(prev.numpy()),
                                hitbox, falloff, max_pen, interpret=True)
    return dict(pos=pos, pos0=pos0, prev=prev, got=got, want=want,
                hitbox=hitbox, falloff=falloff, max_pen=max_pen)


def test_pair_collision_clouds_clear_of_thresholds(collision_case):
    c = collision_case
    assert _threshold_margin(c["pos"], (c["hitbox"], c["falloff"])) > MARGIN
    assert _threshold_margin(c["pos0"], (c["hitbox"],)) > MARGIN
    n = c["pos"].shape[1]
    prev = t_si.unpack_pairs(c["prev"], n).numpy()
    curr = t_si.unpack_pairs(c["got"][4], n).numpy()
    assert (curr & ~prev).any(), "no new pair"
    assert (curr & prev).any(), "no repeated pair"
    assert (~curr & prev).any(), "no ended pair"


@pytest.mark.parametrize("field", ["col_any", "resp_any", "resp_partner",
                                   "curr_packed"])
def test_pair_collisions_masks_equal_jax(collision_case, field):
    i = {"col_any": 0, "resp_any": 2, "resp_partner": 3, "curr_packed": 4}[
        field]
    got, want = collision_case["got"][i], collision_case["want"][i]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pair_collisions_dtypes(collision_case):
    col, pen, rany, partner, packed = collision_case["got"]
    assert (col.dtype, pen.dtype, rany.dtype, partner.dtype,
            packed.dtype) == (torch.bool, torch.float32, torch.bool,
                              torch.int32, torch.int32)


def test_pair_collisions_penalty_matches_jax(collision_case):
    np.testing.assert_allclose(collision_case["got"][1].numpy(),
                               np.asarray(collision_case["want"][1]),
                               **PEN_TOL)


def test_pair_collisions_match_dense_route(collision_case):
    """Against what the dense env route derives from (N, N) masks: the
    previous tick's bits decode to its collision matrix, and col_any, the
    response inputs, the bits and the penalty follow."""
    c = collision_case
    n = c["pos"].shape[1]
    col, pen, rany, partner, packed = c["got"]
    for env in range(c["pos"].shape[0]):
        _, prev_dense = t_coll.collision_matrix(_t(c["pos0"][env]),
                                                c["hitbox"])
        np.testing.assert_array_equal(
            t_si.unpack_pairs(c["prev"][env], n).numpy(), prev_dense.numpy())
        curr, active, want_partner = _dense_expectation(
            c["pos"][env], prev_dense.numpy(), c["hitbox"])
        np.testing.assert_array_equal(col[env].numpy(), curr.any(1))
        np.testing.assert_array_equal(rany[env].numpy(), active)
        np.testing.assert_array_equal(partner[env].numpy(), want_partner)
        np.testing.assert_array_equal(
            t_si.unpack_pairs(packed[env], n).numpy(), curr)
        dist, _ = t_coll.collision_matrix(_t(c["pos"][env]), c["hitbox"])
        want_pen = t_reward.proximity_penalties(
            dist, dist <= c["falloff"], c["falloff"], c["max_pen"], 1.0)
        np.testing.assert_allclose(pen[env].numpy(), want_pen.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_pair_collisions_two_new_partners_and_history():
    """Drone 1 meets drones 0, 3 and 4 at once.  Partner order: the lowest
    new j > d first, else the lowest new i < d, else 0.  A pair that was
    already colliding is not new."""
    pos = np.zeros((1, 6, 3), np.float32)
    pos[0, :, 0] = [0.0, 0.1, 5.0, 0.2, 0.15, 9.0]
    hitbox, falloff = 0.12, 0.3
    assert _threshold_margin(pos, (hitbox, falloff)) > MARGIN
    zeros = torch.zeros((1, 6, t_si.PACK_LANES), dtype=torch.int32)
    col, pen, rany, partner, packed = t_si.pair_collisions(
        _t(pos), zeros, hitbox, falloff, 1.0)
    want = j_si.pair_collisions(jnp.asarray(pos), jnp.asarray(zeros.numpy()),
                                hitbox, falloff, 1.0, interpret=True)
    # pairs within 0.12: (0,1), (1,3), (1,4), (3,4)
    assert col[0].tolist() == [True, True, False, True, True, False]
    assert rany[0].tolist() == col[0].tolist()
    assert partner[0].tolist() == [1, 3, 0, 4, 1, 0]
    for g, w in zip((col, rany, partner, packed),
                    (want[0], want[2], want[3], want[4])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(pen.numpy(), np.asarray(want[1]), **PEN_TOL)
    # unit penalty of drone 5, alone: 0; of drone 0: (1 - .1/.3) + (1 - .15/.3)
    # + (1 - .2/.3)
    np.testing.assert_allclose(pen[0, [0, 5]].numpy(),
                               [3 - 0.45 / 0.3, 0.0], atol=1e-5)
    # next tick: (1,3) was colliding, so drone 1's first new partner is 4 and
    # drone 3 falls back to its other new pair (3,4); drone 0 has none
    prev = t_si.pack_pairs(_t(np.array(
        [[(i, j) in ((0, 1), (1, 0), (1, 3), (3, 1)) for j in range(6)]
         for i in range(6)]))[None])
    _, _, rany2, partner2, packed2 = t_si.pair_collisions(
        _t(pos), prev, hitbox, falloff, 1.0)
    want2 = j_si.pair_collisions(jnp.asarray(pos), jnp.asarray(prev.numpy()),
                                 hitbox, falloff, 1.0, interpret=True)
    assert rany2[0].tolist() == [False, True, False, True, True, False]
    assert partner2[0].tolist() == [0, 4, 0, 4, 1, 0]
    np.testing.assert_array_equal(rany2.numpy(), np.asarray(want2[2]))
    np.testing.assert_array_equal(partner2.numpy(), np.asarray(want2[3]))
    assert torch.equal(packed2, packed)


# --------------------------------------------------------------------------
# K3: k-nearest neighbour observation
# --------------------------------------------------------------------------

def _metric_gap(pos, vel, k) -> float:
    """Least gap between consecutive selection metrics among each drone's
    k + 1 smallest, in float64."""
    dp = pos[..., None, :, :].astype(np.float64) - pos[..., :, None, :]
    dv = vel[..., None, :, :].astype(np.float64) - vel[..., :, None, :]
    ds = np.maximum(np.sqrt((dp * dp).sum(-1)), 0.01)
    metric = ds + (dp * dv).sum(-1) / ds
    metric[..., np.eye(pos.shape[-2], dtype=bool)] = np.inf
    low = np.sort(metric, -1)[..., :k + 1]
    return float(np.diff(low, axis=-1).min())


@pytest.fixture(scope="module")
def topk_case():
    e, n, k = 2, 140, 6
    for s in range(3, 53):
        rng = np.random.default_rng(s)
        pos = rng.uniform(-4, 4, (e, n, 3)).astype(np.float32)
        vel = rng.uniform(-2, 2, (e, n, 3)).astype(np.float32)
        if _metric_gap(pos, vel, k) > 1e-4:
            break
    return pos, vel, k


def test_neighbor_topk_obs_matches_jax(topk_case):
    pos, vel, k = topk_case
    assert _metric_gap(pos, vel, k) > 1e-4
    got = t_si.neighbor_topk_obs(_t(pos), _t(vel), k)
    want = j_si.neighbor_topk_obs(jnp.asarray(pos), jnp.asarray(vel), k,
                                  interpret=True)
    assert got.shape == (2, 140, k * 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOPK_TOL)


def test_neighbor_topk_obs_picks_the_dense_routes_neighbors(topk_case):
    """The same neighbours, in the same slots, as the port's dense
    `neighbor_obs`: the picked [dp, dv] are then equal bit for bit."""
    pos, vel, k = topk_case
    idx = t_neighbors.neighbor_indices(_t(pos), _t(vel), k)
    metric = t_si.neighbor_topk_metric(_t(pos), _t(vel))
    picks = torch.sort(metric, dim=-1, stable=True).indices[..., :k]
    assert torch.equal(picks, idx)
    got = t_si.neighbor_topk_obs(_t(pos), _t(vel), k)
    assert torch.equal(got, t_neighbors.neighbor_obs(_t(pos), _t(vel), k))


def test_neighbor_topk_exact_ties_go_to_lowest_index():
    """Drones 1..4 sit at the same distance from drone 0 with zero velocity:
    equal metrics, so slots fill in index order, as in the JAX kernel."""
    pos = np.zeros((1, 6, 3), np.float32)
    pos[0, 1:5] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0]]
    pos[0, 5] = [5.0, 5.0, 5.0]
    vel = np.zeros_like(pos)
    got = t_si.neighbor_topk_obs(_t(pos), _t(vel), 3).reshape(1, 6, 3, 6)
    want = j_si.neighbor_topk_obs(jnp.asarray(pos), jnp.asarray(vel), 3,
                                  interpret=True)
    np.testing.assert_array_equal(got[0, 0, :, :3].numpy(), pos[0, 1:4])
    np.testing.assert_allclose(got.reshape(1, 6, 18).numpy(),
                               np.asarray(want), atol=1e-6)
    idx = t_neighbors.neighbor_indices(_t(pos), _t(vel), 3)
    assert idx[0, 0].tolist() == [1, 2, 3]


def test_neighbor_topk_metric_uses_radial_velocity():
    """An approaching far drone beats a receding near one."""
    pos = np.array([[[0, 0, 0], [1.0, 0, 0], [2.0, 0, 0]]], np.float32)
    vel = np.array([[[0, 0, 0], [1.5, 0, 0], [-1.5, 0, 0]]], np.float32)
    got = t_si.neighbor_topk_obs(_t(pos), _t(vel), 1)
    assert got[0, 0].tolist() == [2.0, 0.0, 0.0, -1.5, 0.0, 0.0]
    metric = t_si.neighbor_topk_metric(_t(pos), _t(vel))
    assert metric[0, 0].tolist() == [float("inf"), 2.5, 0.5]


# --------------------------------------------------------------------------
# K4: interaction reduction
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def interaction_case():
    n = 200
    hitbox, falloff, max_pen = 0.5, 1.5, 10.0
    pos = _cloud(0, (n,), 3.0, (hitbox, falloff))
    got = t_si.swarm_interactions(_t(pos), hitbox, falloff, max_pen)
    want = j_si.swarm_interactions(jnp.asarray(pos), hitbox, falloff, max_pen,
                                   interpret=True)
    return pos, (hitbox, falloff, max_pen), got, want


def test_swarm_interactions_matches_jax(interaction_case):
    pos, (hitbox, falloff, _), got, want = interaction_case
    assert _threshold_margin(pos, (hitbox, falloff)) > MARGIN
    col, partner, penalty, min_dist = got
    assert col.shape == partner.shape == penalty.shape == min_dist.shape \
        == (200,)
    assert (col.dtype, partner.dtype) == (torch.bool, torch.int32)
    np.testing.assert_array_equal(col.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(partner.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(penalty.numpy(), np.asarray(want[2]), **PEN_TOL)
    np.testing.assert_allclose(min_dist.numpy(), np.asarray(want[3]),
                               rtol=1e-4, atol=1e-4)


def test_swarm_interactions_matches_dense(interaction_case):
    pos, (hitbox, falloff, max_pen), got, _ = interaction_case
    col, partner, penalty, min_dist = got
    dist = _dist64(pos) + np.eye(200) * 1e9
    np.testing.assert_array_equal(col.numpy(), (dist <= hitbox).any(1))
    np.testing.assert_array_equal(partner.numpy(), dist.argmin(1))
    np.testing.assert_allclose(min_dist.numpy(), dist.min(1), rtol=1e-6)
    want_pen = np.where(dist <= falloff, max_pen - max_pen / falloff * dist,
                        0.0).sum(1)
    np.testing.assert_allclose(penalty.numpy(), want_pen, rtol=1e-4,
                               atol=1e-4)


def test_swarm_interactions_batched_form_agrees_with_single(interaction_case):
    pos, scalars, got, _ = interaction_case
    batched = t_si.swarm_interactions(_t(np.stack([pos, pos[::-1]])), *scalars)
    for b, g in zip(batched, got):
        assert b.shape == (2, 200) and torch.equal(b[0], g)
    assert torch.equal(batched[3][1], got[3].flip(0))


def test_swarm_interactions_small_fleet():
    pos = np.random.default_rng(1).uniform(-1, 1, (8, 3)).astype(np.float32)
    col, partner, _, _ = t_si.swarm_interactions(_t(pos), 2.0, 4.0, 10.0)
    want = j_si.swarm_interactions(jnp.asarray(pos), 2.0, 4.0, 10.0,
                                   interpret=True)
    assert col.all() and bool((partner < 8).all())
    np.testing.assert_array_equal(partner.numpy(), np.asarray(want[1]))


# --------------------------------------------------------------------------
# Refusals and the launch counters
# --------------------------------------------------------------------------

def test_refusals():
    big = torch.zeros((1, t_si.MAX_AGENTS + 1, 3))
    with pytest.raises(ValueError, match="2048"):
        t_si.pair_collisions(
            big, torch.zeros((1, t_si.MAX_AGENTS + 1, t_si.PACK_LANES),
                             dtype=torch.int32), 0.1, 0.2, 1.0)
    with pytest.raises(ValueError, match="2048"):
        t_si.pack_pairs(torch.zeros((2049, 2049), dtype=torch.bool))
    pos = torch.zeros((1, 20, 3))
    with pytest.raises(ValueError, match="k must be"):
        t_si.neighbor_topk_obs(pos, pos, 17)
    with pytest.raises(ValueError, match="k must be"):
        t_si.neighbor_topk_obs(pos, pos, 0)
    with pytest.raises(ValueError, match="neighbours of N"):
        t_si.neighbor_topk_obs(pos[:, :5], pos[:, :5], 5)
    with pytest.raises(TypeError):
        t_si.neighbor_topk_obs(pos.double(), pos.double(), 3)
    with pytest.raises(TypeError):
        t_si.pair_collisions(pos, torch.zeros((1, 20, t_si.PACK_LANES)),
                             0.1, 0.2, 1.0)
    with pytest.raises(ValueError, match="shape"):
        t_si.pair_collisions(pos, torch.zeros((1, 20, 8), dtype=torch.int32),
                             0.1, 0.2, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        t_si.swarm_interactions(torch.zeros((1, 3, 20)).transpose(1, 2),
                                0.1, 0.2, 1.0)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    before = (t_si.pair_collisions.launches, t_si.neighbor_topk_obs.launches,
              t_si.swarm_interactions.launches)
    pos = _t(np.random.default_rng(0).uniform(-1, 1, (1, 9, 3))
             .astype(np.float32))
    zeros = torch.zeros((1, 9, t_si.PACK_LANES), dtype=torch.int32)
    for g, w in zip(t_si.pair_collisions(pos, zeros, 0.5, 1.0, 1.0),
                    t_si.pair_collisions_plain(pos, zeros, 0.5, 1.0, 1.0)):
        assert torch.equal(g, w)
    assert torch.equal(t_si.neighbor_topk_obs(pos, pos.flip(1), 4),
                       t_si.neighbor_topk_obs_plain(pos, pos.flip(1), 4))
    for g, w in zip(t_si.swarm_interactions(pos, 0.5, 1.0, 1.0),
                    t_si.swarm_interactions_plain(pos, 0.5, 1.0, 1.0)):
        assert torch.equal(g, w)
    assert before == (t_si.pair_collisions.launches,
                      t_si.neighbor_topk_obs.launches,
                      t_si.swarm_interactions.launches)
