"""Pinhole camera model with Brown-Conrady distortion (pure jitted JAX).

Replaces the reference's OpenCV calls — ``cv2.undistortPoints``
(``3d_reconstruction.py:185-193``), ``cv2.projectPoints``
(``extrinsic_calibration.py:117``) — with batched, differentiable array ops.
Distortion coefficients follow OpenCV's ``[k1, k2, p1, p2, k3]`` convention
everywhere (normalizing the reference's inconsistent orders, SURVEY.md §2.2
quirks 6/7).

The model is a JAX pytree so it can be passed through ``jit``/``vmap``/
``grad`` and sharded like any other array structure.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class CameraModel(NamedTuple):
    """Intrinsics (+ optional extrinsics) of a pinhole camera.

    Attributes:
      fx, fy, cx, cy, skew: intrinsic parameters (pixels).
      dist: ``(5,)`` distortion coefficients ``[k1, k2, p1, p2, k3]``.
      R_wc: ``(3, 3)`` world->camera rotation.
      T_wc: ``(3,)`` world->camera translation (mm).
    """
    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    skew: jnp.ndarray
    dist: jnp.ndarray
    R_wc: jnp.ndarray
    T_wc: jnp.ndarray

    @classmethod
    def create(cls, fx, fy, cx, cy, skew=0.0, dist=None, R_wc=None, T_wc=None,
               dtype=jnp.float32) -> "CameraModel":
        dist = jnp.zeros(5, dtype) if dist is None else jnp.asarray(dist, dtype)
        dist = jnp.concatenate([dist, jnp.zeros(5 - dist.shape[0], dtype)]) if dist.shape[0] < 5 else dist[:5]
        R_wc = jnp.eye(3, dtype=dtype) if R_wc is None else jnp.asarray(R_wc, dtype)
        T_wc = jnp.zeros(3, dtype) if T_wc is None else jnp.reshape(jnp.asarray(T_wc, dtype), (3,))
        as_s = lambda v: jnp.asarray(v, dtype)
        return cls(as_s(fx), as_s(fy), as_s(cx), as_s(cy), as_s(skew), dist, R_wc, T_wc)

    @property
    def K(self) -> jnp.ndarray:
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        return jnp.stack([
            jnp.stack([self.fx, self.skew, self.cx]),
            jnp.stack([z, self.fy, self.cy]),
            jnp.stack([z, z, o]),
        ])

    @property
    def f_avg(self) -> jnp.ndarray:
        """Mean focal length used by depth-from-diameter (3d_reconstruction.py:211)."""
        return (self.fx + self.fy) / 2.0


def distort_normalized(cam: CameraModel, xy: jnp.ndarray) -> jnp.ndarray:
    """Apply Brown-Conrady distortion to normalized coords ``(..., 2)``."""
    k1, k2, p1, p2, k3 = (cam.dist[i] for i in range(5))
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return jnp.stack([xd, yd], axis=-1)


def normalized_to_pixel(cam: CameraModel, xy: jnp.ndarray) -> jnp.ndarray:
    u = cam.fx * xy[..., 0] + cam.skew * xy[..., 1] + cam.cx
    v = cam.fy * xy[..., 1] + cam.cy
    return jnp.stack([u, v], axis=-1)


def pixel_to_normalized(cam: CameraModel, uv: jnp.ndarray) -> jnp.ndarray:
    y = (uv[..., 1] - cam.cy) / cam.fy
    x = (uv[..., 0] - cam.cx - cam.skew * y) / cam.fx
    return jnp.stack([x, y], axis=-1)


def project_points(cam: CameraModel, p_world: jnp.ndarray) -> jnp.ndarray:
    """World points ``(..., 3)`` -> distorted pixel coords ``(..., 2)``.

    Equivalent to ``cv2.projectPoints`` with this camera's R/T/K/dist.
    """
    p_cam = jnp.matmul(p_world, cam.R_wc.T,
                       precision=jax.lax.Precision.HIGHEST) + cam.T_wc
    xy = p_cam[..., :2] / p_cam[..., 2:3]
    return normalized_to_pixel(cam, distort_normalized(cam, xy))


def undistort_points(cam: CameraModel, uv: jnp.ndarray, iters: int = 5,
                     to_pixels: bool = True) -> jnp.ndarray:
    """Iteratively invert the distortion model for pixel points ``(..., 2)``.

    Matches ``cv2.undistortPoints(pts, K, dist, None, K)`` as used at
    ``3d_reconstruction.py:185-193``: the same fixed-point iteration
    ``x <- (xd - tangential(x)) / radial(x)``, ``iters`` (OpenCV default 5)
    rounds. With ``to_pixels`` the result is re-projected through K (the
    reference passes K as the new camera matrix); otherwise normalized
    coordinates are returned.
    """
    xd = pixel_to_normalized(cam, uv)
    k1, k2, p1, p2, k3 = (cam.dist[i] for i in range(5))

    def body(_, x):
        xx, yy = x[..., 0], x[..., 1]
        r2 = xx * xx + yy * yy
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * xx * yy + p2 * (r2 + 2.0 * xx * xx)
        dy = p1 * (r2 + 2.0 * yy * yy) + 2.0 * p2 * xx * yy
        xn = (xd[..., 0] - dx) / radial
        yn = (xd[..., 1] - dy) / radial
        return jnp.stack([xn, yn], axis=-1)

    x = jax.lax.fori_loop(0, iters, body, xd)
    return normalized_to_pixel(cam, x) if to_pixels else x


def backproject_depth_from_diameter(
    cam: CameraModel,
    uv_undist: jnp.ndarray,
    diameter_px: jnp.ndarray,
    marker_diameter_mm: float,
) -> jnp.ndarray:
    """Monocular depth-from-diameter back-projection (reference C12).

    Vectorizes ``3d_reconstruction.py:195-228``: for undistorted pixel
    coordinates ``(..., 2)`` and observed marker diameters ``(...,)``,

      R      = || (u,v) - (cx,cy) ||                 (:215)
      d_eff  = (D_mm / f_avg) * sqrt(R^2 + f_avg^2)  (:219, foreshortening)
      h      = f_avg * d_eff / d_px                  (:220)
      P_cam  = [h (u-cx)/fx, h (v-cy)/fy, h]         (:223-225)
      P_world = R_wc^T (P_cam - T_wc)                (:228)

    Returns world coordinates ``(..., 3)``.
    """
    f_avg = cam.f_avg
    du = uv_undist[..., 0] - cam.cx
    dv = uv_undist[..., 1] - cam.cy
    R = jnp.sqrt(du * du + dv * dv)
    d_eff = (marker_diameter_mm / f_avg) * jnp.sqrt(R * R + f_avg * f_avg)
    h = f_avg * d_eff / jnp.maximum(diameter_px, 1e-6)
    p_cam = jnp.stack([h * du / cam.fx, h * dv / cam.fy, h], axis=-1)
    return jnp.matmul(p_cam - cam.T_wc, cam.R_wc,
                      precision=jax.lax.Precision.HIGHEST)
