"""Rotation / quaternion math over arbitrary leading batch dimensions.

Port of quadswarm_tpu/ops/rotations.py, limited to what the rollout path
calls: Rodrigues' incremental rotation, Newton-polar re-orthonormalization,
the quaternion helpers of the sensor-noise model and yaw rotations.
"""
from __future__ import annotations

import torch

EPS = 1e-6


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric (hat) operator: hat(w) @ v == w x v."""
    wx, wy, wz = w.unbind(-1)
    zero = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zero, -wz, wy], -1),
        torch.stack([wz, zero, -wx], -1),
        torch.stack([-wy, wx, zero], -1),
    ], -2)


def rodrigues(omega_world: torch.Tensor, dt: float) -> torch.Tensor:
    """exp(hat(omega_world) * dt); the identity where the norm is zero."""
    norm = torch.linalg.vector_norm(omega_world, dim=-1)
    nonzero = norm > 0.0
    safe = torch.where(nonzero, norm, torch.ones_like(norm))
    k = hat(omega_world / safe[..., None])
    angle = (norm * dt)[..., None, None]
    eye = torch.eye(3, dtype=omega_world.dtype, device=omega_world.device)
    eye = eye.expand(k.shape)
    d_rot = eye + torch.sin(angle) * k + (1.0 - torch.cos(angle)) * (k @ k)
    return torch.where(nonzero[..., None, None], d_rot, eye)


def reorthonormalize(rot: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """Newton iteration for the orthogonal polar factor:
    R <- 1.5 R - 0.5 R R^T R."""
    for _ in range(iters):
        rot = 1.5 * rot - 0.5 * rot @ rot.transpose(-1, -2) @ rot
    return rot


def quat2rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [w, x, y, z] -> rotation matrix."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1.0 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * z * w,
                     2 * x * z + 2 * y * w], -1),
        torch.stack([2 * x * y + 2 * z * w, 1.0 - 2 * x**2 - 2 * z**2,
                     2 * y * z - 2 * x * w], -1),
        torch.stack([2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
                     1.0 - 2 * x**2 - 2 * y**2], -1),
    ], -2)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, [w, x, y, z] layout."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw - ay * bz + az * by,
        aw * by + ax * bz + ay * bw - az * bx,
        aw * bz - ax * by + ay * bx + az * bw,
    ], -1)


def rot2quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion [w, x, y, z]: all four candidate
    solutions, selected by the classic predicate ladder."""
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    trace = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=EPS)) * 2

    s0 = root(trace + 1.0)
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], -1)
    s1 = root(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], -1)
    s2 = root(1.0 + m11 - m00 - m22)
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], -1)
    s3 = root(1.0 + m22 - m00 - m11)
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], -1)
    c0 = (trace > 0)[..., None]
    c1 = ((m00 > m11) & (m00 > m22))[..., None]
    c2 = (m11 > m22)[..., None]
    return torch.where(c0, q0, torch.where(c1, q1, torch.where(c2, q2, q3)))


def quat_from_small_angle(theta: torch.Tensor) -> torch.Tensor:
    """Small-angle rotation vector -> unit quaternion."""
    q_squared = torch.sum(theta**2, -1, keepdim=True) / 4.0
    w_small = torch.sqrt(torch.clamp(1.0 - q_squared, min=0.0))
    q_small = torch.cat([w_small, theta * 0.5], -1)
    w_big = 1.0 / torch.sqrt(1.0 + q_squared)
    q_big = torch.cat([w_big, theta * (0.5 * w_big)], -1)
    q = torch.where(q_squared < 1.0, q_small, q_big)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def yaw_rot(theta: torch.Tensor) -> torch.Tensor:
    """Yaw-only rotation matrix."""
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(theta), torch.ones_like(theta)
    return torch.stack([
        torch.stack([c, -s, zero], -1),
        torch.stack([s, c, zero], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
