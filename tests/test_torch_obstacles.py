"""Parity of the port's obstacle pieces with the JAX package.

- `surround_sdf_obs` and `obstacle_collisions` against the JAX functions
  env by env (float32, the slice's tolerance rtol 2e-4 / atol 2e-5; hits and
  nearest indices equal), on an empty grid (the value 100 - r), with a
  drone exactly at r_quad + r_obst from an axis and one a float32 step
  beyond it, and with inactive cells nearer than every active one;
- `obstacle_collision_response` against JAX's with the same draws (JAX
  through its `set_response_tape`), in float64 (atol 1e-10), over rows
  inside the cylinder, rows at zero speed, rows where no noise attempt
  leaves the obstacle and rows that did not hit;
- `max_free_square_center`: the centre's xy equal to JAX's on random maps,
  an all-free map, a full map, a map whose first row and column are
  occupied (the table's seeding quirk) and a 6 x 8 grid (the index clamp);
- `generate_obstacle_grid` and `sample_free_cells`, whose draws come from
  a torch generator, by invariants: as many obstacles as JAX places for
  every density of the domain-random grid at spawn areas 6 x 6 and 8 x 8,
  distinct free cells, z at half the room for obstacles and in [1, 3) for
  spawns.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadswarm_tpu.env import collisions as j_coll
from quadswarm_tpu.env import obstacles as j_obst
from quadswarm_tpu.env import scenarios as j_scen
from quadswarm_tpu_torch.env import collisions as t_coll
from quadswarm_tpu_torch.env import obstacles as t_obst
from quadswarm_tpu_torch.env import scenarios as t_scen

from .test_torch_env_parts import F64, j64, t64

TOL = dict(rtol=2e-4, atol=2e-5)
ARM = np.float32(0.05)
SIZE = np.float32(0.6)
E, N = 3, 4


def _centers(a0, a1):
    return t_obst.cell_centers(a0, a1).astype(np.float32)


def test_cell_centers_match_jax():
    for area in ((6, 6), (8, 8), (6, 8)):
        np.testing.assert_array_equal(t_obst.cell_centers(*area),
                                      j_obst.cell_centers(*area))


@pytest.fixture(scope="module")
def sdf_case():
    """3 envs of 4 drones on the 8 x 8 grid: env 0 with no obstacle; env 1
    with drone 0 exactly at r_quad + r_obst from an active axis and drone 1
    one float32 step beyond; env 2 with every drone on an inactive cell
    and the active ones farther away."""
    rng = np.random.default_rng(0)
    centers = _centers(8, 8)
    c = centers.shape[0]
    obst_xy = np.broadcast_to(centers, (E, c, 2)).copy()
    active = np.zeros((E, c), bool)
    active[1, rng.choice(c, 12, replace=False)] = True
    active[2, :] = np.abs(centers[:, 0]) > 2.0          # only the outer band
    quad = rng.uniform(-3.5, 3.5, (E, N, 2)).astype(np.float32)
    radius = np.float32(ARM + np.float32(SIZE / np.float32(2.0)))
    # an active axis at x = -0.5: x = radius - 0.5 is exact (Sterbenz), so
    # the drone's distance x + 0.5 is radius to the bit
    k = int(np.flatnonzero(centers[:, 0] == -0.5)[2])
    active[1, k] = True
    ox, oy = obst_xy[1, k]
    x = np.float32(radius + ox)
    assert np.float32(x - ox) == radius
    beyond = np.nextafter(x, np.float32(np.inf))
    while not np.float32(beyond - ox) > radius:
        beyond = np.nextafter(beyond, np.float32(np.inf))
    quad[1, 0] = [x, oy]
    quad[1, 1] = [beyond, oy]
    quad[2] = centers[~active[2]][:N] + np.float32(0.05)
    return quad, obst_xy, active, radius


def test_surround_sdf_and_hits_match_jax(sdf_case):
    quad, obst_xy, active, radius = sdf_case
    r = np.full((E,), SIZE / np.float32(2.0), np.float32)
    sdf = jax.jit(jax.vmap(j_obst.surround_sdf_obs))(
        jnp.asarray(quad), jnp.asarray(obst_xy), jnp.asarray(active),
        jnp.asarray(r))
    hit, nearest = jax.jit(jax.vmap(
        lambda q, o, a, rr: j_obst.obstacle_collisions(q, o, a, rr, ARM)))(
        jnp.asarray(quad), jnp.asarray(obst_xy), jnp.asarray(active),
        jnp.asarray(r))
    t_sdf = t_obst.surround_sdf_obs(torch.from_numpy(quad),
                                    torch.from_numpy(obst_xy),
                                    torch.from_numpy(active),
                                    torch.from_numpy(r))
    t_hit, t_nearest = t_obst.obstacle_collisions(
        torch.from_numpy(quad), torch.from_numpy(obst_xy),
        torch.from_numpy(active), torch.from_numpy(r), float(ARM))
    assert t_sdf.shape == (E, N, 9) and t_sdf.dtype == torch.float32
    np.testing.assert_allclose(t_sdf.numpy(), np.asarray(sdf), **TOL)
    np.testing.assert_array_equal(t_hit.numpy(), np.asarray(hit))
    np.testing.assert_array_equal(t_nearest.numpy(), np.asarray(nearest))
    # the empty grid: 100 - r everywhere, nothing hit, partner 0
    np.testing.assert_array_equal(t_sdf[0].numpy(),
                                  np.float32(100.0) - r[0])
    assert not t_hit[0].any() and not t_nearest[0].any()
    # on the boundary is a hit, one step beyond is not
    assert t_hit[1, :2].tolist() == [True, False]
    # nearest is the nearest ACTIVE cell, never the drone's own inactive one
    assert active[2][t_nearest[2].numpy()].all() and not t_hit[2].any()


def _response_case():
    """8 drones: 0-1 ordinary hits, 2 inside the cylinder, 3 at zero speed,
    4 with no noise attempt that leaves the obstacle, 5 inside and at rest,
    6-7 not hit."""
    rng = np.random.default_rng(3)
    n = 8
    obstacle = rng.uniform(-3, 3, (n, 3))
    obstacle[:, 2] = 5.0
    direction = rng.normal(0, 1, (n, 3))
    direction[:, 2] = 0.0
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    pos = obstacle + 0.33 * direction
    pos[:, 2] = rng.uniform(1.0, 3.0, n)
    pos[[2, 5], 2] = 5.0 + 0.01                     # within size / 2 in 3-D
    pos[[2, 5], :2] = obstacle[[2, 5], :2] + 0.1 * direction[[2, 5], :2]
    vel = rng.normal(0, 2, (n, 3))
    vel[[3, 5]] = 0.0
    omega = rng.normal(0, 1, (n, 3))
    normals = rng.standard_normal((n, 3, 2, 3))
    uniforms = rng.uniform(0, 1, (n, 5))
    # drone 4: its speed small and every attempt pushing into the axis
    vel[4] = 0.01 * direction[4]
    normals[4, :, 0, :] = -5.0 * direction[4]
    normals[4, :, 1, :] = 0.0
    hit = np.array([True] * 6 + [False] * 2)
    return pos, vel, omega, obstacle, hit, normals, uniforms


def test_obstacle_collision_response_with_tape():
    pos, vel, omega, obstacle, hit, normals, uniforms = _response_case()
    j_coll.set_response_tape({"obst_normals": normals,
                              "obst_uniforms": uniforms})
    try:
        want = j_coll.obstacle_collision_response(
            jax.random.PRNGKey(0), j64(pos), j64(vel), j64(omega),
            j64(obstacle), j64(SIZE), jnp.asarray(hit))
    finally:
        j_coll.set_response_tape(None)
    got = t_coll.obstacle_collision_response(
        t64(pos), t64(vel), t64(omega), t64(obstacle), t64(SIZE),
        torch.as_tensor(hit), None, t64(normals), t64(uniforms))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F64)
    new_vel, new_omega = (x.numpy() for x in got)
    # the rows the case was built for
    speed = np.linalg.norm(vel, axis=-1)
    assert np.array_equal(new_vel[6:], vel[6:])
    assert np.array_equal(new_omega[6:], omega[6:])
    assert np.allclose(new_vel[[3, 5]], 0.0)          # at rest stays at rest
    assert (np.linalg.norm(new_omega[:6] - omega[:6], axis=-1)
            >= np.pi / 2 - 1e-9).all()                # every hit is kicked
    assert np.linalg.norm(new_vel[2]) <= speed[2] + 1e-12
    # drone 4: no noise, so it leaves straight along the normal
    n4 = pos[4, :2] - obstacle[4, :2]
    cos = new_vel[4, :2] @ n4 / (np.linalg.norm(new_vel[4, :2])
                                 * np.linalg.norm(n4))
    assert abs(new_vel[4, 2]) < 1e-12 and cos == pytest.approx(1.0, abs=1e-9)
    # the port's own tape seam gives the same
    t_coll.set_response_tape({"obst_normals": normals,
                              "obst_uniforms": uniforms})
    try:
        taped = t_coll.obstacle_collision_response(
            t64(pos), t64(vel), t64(omega), t64(obstacle), t64(SIZE),
            torch.as_tensor(hit))
    finally:
        t_coll.set_response_tape(None)
    for g, w in zip(taped, got):
        assert torch.equal(g, w)


def _square_maps():
    rng = np.random.default_rng(5)
    maps = [rng.uniform(0, 1, (8, 8)) < p for p in (0.1, 0.2, 0.2, 0.35,
                                                    0.5, 0.7)]
    maps.append(np.zeros((8, 8), bool))
    maps.append(np.ones((8, 8), bool))
    quirk = np.zeros((8, 8), bool)
    quirk[0, :] = quirk[:, 0] = True
    maps.append(quirk)
    return np.stack(maps)


@pytest.mark.parametrize("area", [(8, 8), (6, 8)])
def test_max_free_square_center_matches_jax(area):
    if area == (8, 8):
        maps = _square_maps()
    else:
        rng = np.random.default_rng(6)
        maps = np.stack([rng.uniform(0, 1, area) < p
                         for p in (0.0, 0.1, 0.3)])
    centers = _centers(*area)
    keys = jax.random.split(jax.random.PRNGKey(0), maps.shape[0])
    want = jax.jit(jax.vmap(lambda k, m: j_scen.max_free_square_center(
        k, m, jnp.asarray(centers), jnp.float32)))(keys, jnp.asarray(maps))
    gen = torch.Generator().manual_seed(0)
    got = t_scen.max_free_square_center(gen, torch.from_numpy(maps),
                                        torch.from_numpy(centers))
    np.testing.assert_array_equal(got[:, :2].numpy(),
                                  np.asarray(want)[:, :2])
    assert ((got[:, 2] >= 1.5) & (got[:, 2] < 3.0)).all()


@pytest.mark.parametrize("area", [(6, 6), (8, 8)])
def test_obstacle_grid_and_free_cells_invariants(area):
    densities = list(np.arange(0.05, 0.2, 0.05)) + [0.2]
    centers = _centers(*area)
    c = centers.shape[0]
    keys = jax.random.split(jax.random.PRNGKey(1), len(densities))
    j_active, _ = jax.jit(jax.vmap(lambda k, d: j_obst.generate_obstacle_grid(
        k, c, d, jnp.asarray(centers), 10.0)))(
        keys, jnp.asarray(densities, jnp.float32))
    gen = torch.Generator().manual_seed(2)
    density = torch.tensor(densities, dtype=torch.float32)
    active, pos = t_obst.generate_obstacle_grid(
        gen, density, torch.from_numpy(centers), 10.0)
    want = np.asarray(j_active).sum(-1)
    assert active.sum(-1).tolist() == want.tolist()
    assert want.tolist() == [int(np.float32(d) * np.float32(c))
                             for d in densities]
    assert (pos[..., 2] == 5.0).all()
    np.testing.assert_array_equal(pos[0, :, :2].numpy(), centers)
    # spawns: distinct free cells at z in [1, 3)
    spawn = t_scen.sample_free_cells(gen, active, torch.from_numpy(centers),
                                     8, 1.0, 3.0)
    assert spawn.shape == (len(densities), 8, 3)
    assert ((spawn[..., 2] >= 1.0) & (spawn[..., 2] < 3.0)).all()
    match = (spawn[..., None, :2] == torch.from_numpy(centers)).all(-1)
    cell = match.to(torch.uint8).argmax(-1)
    assert match.any(-1).all()
    for env in range(len(densities)):
        assert len(set(cell[env].tolist())) == 8
        assert not active[env, cell[env]].any()
