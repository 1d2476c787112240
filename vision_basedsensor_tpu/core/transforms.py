"""Rigid-body transforms (pure jitted JAX).

Replaces the reference's scattered uses of ``cv2.Rodrigues``
(``extrinsic_calibration.py:113``, ``intrinsic_calibration.py:160``) and the
hand-written world<->camera algebra of ``3d_reconstruction.py:223-228`` with
batched, differentiable primitives.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def rodrigues(rvec: jnp.ndarray) -> jnp.ndarray:
    """Rotation vector(s) ``(..., 3)`` -> rotation matrix(es) ``(..., 3, 3)``.

    Numerically safe at theta -> 0 (second-order Taylor terms).
    """
    rvec = jnp.asarray(rvec)
    theta = jnp.linalg.norm(rvec, axis=-1, keepdims=True)
    theta = theta[..., None]  # (..., 1, 1)
    safe = jnp.maximum(theta, 1e-12)
    k = rvec[..., None, :] / safe  # unit axis as row (..., 1, 3)
    kx, ky, kz = k[..., 0, 0], k[..., 0, 1], k[..., 0, 2]
    zeros = jnp.zeros_like(kx)
    K = jnp.stack([
        jnp.stack([zeros, -kz, ky], axis=-1),
        jnp.stack([kz, zeros, -kx], axis=-1),
        jnp.stack([-ky, kx, zeros], axis=-1),
    ], axis=-2)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=rvec.dtype), K.shape)
    sin_t = jnp.sin(theta)
    cos_t = jnp.cos(theta)
    R = eye + sin_t * K + (1.0 - cos_t) * (K @ K)
    # theta ~ 0: R ~ I + K*theta (K here is the normalized one; fall back to skew(rvec)).
    Kraw = K * safe
    R_small = eye + Kraw + 0.5 * (Kraw @ Kraw)
    return jnp.where(theta < 1e-8, R_small, R)


def inverse_rodrigues(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix(es) ``(..., 3, 3)`` -> rotation vector(s) ``(..., 3)``.

    Handles all three regimes branchlessly: generic (axis from the
    antisymmetric part), theta -> 0 (w/2), and theta -> pi where the
    antisymmetric part vanishes — there the axis is recovered from
    ``k k^T = (R + I)/2`` via its largest diagonal (the same strategy
    cv2.Rodrigues uses), with the sign taken from the residual
    antisymmetric part when it is nonzero.
    """
    R = jnp.asarray(R)
    trace = jnp.trace(R, axis1=-2, axis2=-1)
    cos_t = jnp.clip((trace - 1.0) / 2.0, -1.0, 1.0)
    w = jnp.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], axis=-1)
    # sin(theta) straight from the antisymmetric part (|w| = 2 sin(theta)) and
    # theta = atan2(sin, cos): uniformly well-conditioned, unlike
    # arccos(cos_t) whose derivative blows up as theta -> pi and silently
    # loses ~3 digits already at theta = pi - 1e-3.
    sin_t = 0.5 * jnp.linalg.norm(w, axis=-1)
    theta = jnp.arctan2(sin_t, cos_t)
    small = (sin_t < 1e-7)[..., None]
    # Generic case: axis = w / (2 sin(theta)); near 0 use w/2 (since w ~ 2 theta k).
    scale = jnp.where(small, 0.5,
                      theta[..., None] / jnp.maximum(2.0 * sin_t[..., None], 1e-30))
    rv_generic = w * scale

    # theta ~ pi: R = 2 k k^T - I, so (R + I)/2 = k k^T. Take the column with
    # the largest diagonal entry (best-conditioned), normalize by sqrt(k_i^2),
    # and orient by the (tiny but sign-carrying) antisymmetric part.
    S = (R + jnp.eye(3, dtype=R.dtype)) * 0.5
    diag = jnp.diagonal(S, axis1=-2, axis2=-1)               # (..., 3)
    i = jnp.argmax(diag, axis=-1)                            # (...,)
    col = jnp.take_along_axis(
        S, jnp.broadcast_to(i[..., None, None], S.shape[:-1] + (1,)), axis=-1
    )[..., 0]                                                # (..., 3) = S[:, i]
    kii = jnp.take_along_axis(diag, i[..., None], axis=-1)   # (..., 1)
    k = col / jnp.sqrt(jnp.maximum(kii, 1e-12))
    flip = jnp.sum(k * w, axis=-1, keepdims=True) < 0.0      # match w's sign (0 -> keep)
    k = jnp.where(flip, -k, k)
    rv_pi = theta[..., None] * k

    near_pi = small & (cos_t[..., None] < 0.0)
    return jnp.where(near_pi, rv_pi, rv_generic)


def world_to_cam(p_world: jnp.ndarray, R_wc: jnp.ndarray, T_wc: jnp.ndarray) -> jnp.ndarray:
    """``P_cam = R @ P_world + T`` for points ``(..., 3)``."""
    return jnp.matmul(p_world, R_wc.T, precision=jax.lax.Precision.HIGHEST) \
        + jnp.reshape(T_wc, (3,))


def cam_to_world(p_cam: jnp.ndarray, R_wc: jnp.ndarray, T_wc: jnp.ndarray) -> jnp.ndarray:
    """``P_world = R^T (P_cam - T)`` — the inverse map used at
    ``3d_reconstruction.py:228``."""
    return jnp.matmul(p_cam - jnp.reshape(T_wc, (3,)), R_wc,
                      precision=jax.lax.Precision.HIGHEST)
