"""Vector and quaternion math of the reference step: a frozen copy of the
port's plain helpers (quaternions are (x, y, z, w))."""
from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3-vector dot product -> (...,) tensor."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def _sumsq(a: torch.Tensor) -> torch.Tensor:
    s = a[..., 0] * a[..., 0]
    for i in range(1, a.shape[-1]):
        s = s + a[..., i] * a[..., i]
    return s


def normalize(a: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Safe normalize; returns `a / max(|a|, eps)`."""
    n = torch.sqrt(torch.clamp_min(_sumsq(a), eps * eps))
    return a / n[..., None]


def quat_mul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product q ⊗ r, both (x,y,z,w)."""
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rx, ry, rz, rw = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    return torch.stack(
        [
            qw * rx + qx * rw + qy * rz - qz * ry,
            qw * ry - qx * rz + qy * rw + qz * rx,
            qw * rz + qx * ry - qy * rx + qz * rw,
            qw * rw - qx * rx - qy * ry - qz * rz,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., 0:3], q[..., 3:4]], -1)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return normalize(q, eps)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by unit quaternion q: v + 2 w (u×v) + 2 u×(u×v), u = q.xyz."""
    u = q[..., :3]
    w = q[..., 3:4]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate by the conjugate (world -> body)."""
    return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> (..., 3, 3) rotation matrix (columns = body axes)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """q <- normalize(q + ½·dt·(ω_quat ⊗ q)), ω_quat = (ωx, ωy, ωz, 0)."""
    wq = torch.cat([omega, torch.zeros_like(omega[..., :1])], dim=-1)
    dq = 0.5 * dt * quat_mul(wq, q)
    return quat_normalize(q + dq)


def orthonormal_basis(n: torch.Tensor):
    """Deterministic branch-free tangent basis (t1, t2) for unit normal n
    (Duff et al.)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t1 = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    t2 = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return t1, t2
