"""Rotation representation conversions (euler / matrix / 6D).

All matrices act on **row vectors** (``v' = v @ R``). The 3x3 products are
written as elementwise float32 arithmetic, never ``torch.matmul``: on the
card a float32 matmul may run in TF32 (about three decimal digits), which
the geometry cannot afford. The JAX package forces full float32 precision on
the same products for the same reason.
"""
import numpy as np
import torch


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 product ``a @ b`` as elementwise float32 arithmetic
    (broadcast over all leading dims)."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def _axis_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    """Rotation matrix about a named axis (pytorch3d element order)."""
    cos, sin = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        flat = (one, zero, zero, zero, cos, -sin, zero, sin, cos)
    elif axis == "Y":
        flat = (cos, zero, sin, zero, one, zero, -sin, zero, cos)
    elif axis == "Z":
        flat = (cos, -sin, zero, sin, cos, zero, zero, zero, one)
    else:
        raise ValueError(f"invalid axis {axis}")
    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))


def euler_angles_to_matrix_np(euler_angles, convention: str = "XYZ"):
    """Numpy variant for host-side constants (the reference poses)."""
    euler_angles = np.asarray(euler_angles)

    def axis_rot(axis, a):
        c, s = np.cos(a), np.sin(a)
        one, zero = np.ones_like(a), np.zeros_like(a)
        flat = {
            "X": (one, zero, zero, zero, c, -s, zero, s, c),
            "Y": (c, zero, s, zero, one, zero, -s, zero, c),
            "Z": (c, -s, zero, s, c, zero, zero, zero, one),
        }[axis]
        return np.stack(flat, axis=-1).reshape(a.shape + (3, 3))

    mats = [axis_rot(c, euler_angles[..., i]) for i, c in enumerate(convention)]
    return mats[0] @ mats[1] @ mats[2]


def euler_angles_to_matrix(euler_angles: torch.Tensor,
                           convention: str = "XYZ") -> torch.Tensor:
    """(..., 3) angles in radians -> (..., 3, 3);
    ``R = R_c0(a0) @ R_c1(a1) @ R_c2(a2)``."""
    matrices = [_axis_rotation(c, euler_angles[..., i])
                for i, c in enumerate(convention)]
    return mm(mm(matrices[0], matrices[1]), matrices[2])


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation matrices in
    the **column-vector** convention (the one SMPL body models use). The
    norm is the square root of the clamped sum of squares, so that a zero
    vector gives the identity with a finite (zero) gradient."""
    angle = torch.sqrt(torch.clamp(
        (axis_angle * axis_angle).sum(-1, keepdim=True), min=1e-24))
    axis = axis_angle / torch.clamp(angle, min=1e-12)
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    K = torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)
    a = angle[..., None]
    eye = torch.eye(3, dtype=axis_angle.dtype,
                    device=axis_angle.device).expand(K.shape)
    return eye + torch.sin(a) * K + (1.0 - torch.cos(a)) * mm(K, K)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Zhou et al. '19 continuous 6D representation -> rotation matrix by
    Gram-Schmidt on the two stored rows (pytorch3d layout: the 6D vector is
    rows 0 and 1 of the matrix)."""
    a1, a2 = d6[..., :3], d6[..., 3:]

    def safe_normalize(v):
        # rsqrt(sum + eps) keeps the gradient finite at v == 0, where a plain
        # norm (or F.normalize) has a NaN or different gradient
        return v * torch.rsqrt((v * v).sum(-1, keepdim=True) + 1e-12)

    b1 = safe_normalize(a1)
    a2_proj = (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = safe_normalize(a2 - a2_proj)
    b3 = _cross(b1, b2)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """First two rows of the rotation matrix, flattened to (..., 6)."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))
