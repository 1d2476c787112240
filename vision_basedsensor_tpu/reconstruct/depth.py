"""Batched monocular 3D reconstruction (reference C12 hot loop).

The reference computes 3D positions with a doubly-nested Python loop —
``groupby(frame) x iterrows(marker)`` with two scalar ``_calculate_3d_position``
calls per observation (``3d_reconstruction.py:263-314``, SURVEY.md §3.4).
Here the whole video is one tensor op: undistort ``(B, 65, 2)`` points, then
depth-from-diameter back-projection, all on the device.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from vision_basedsensor_tpu.config import ReconstructConfig
from vision_basedsensor_tpu.core import camera as cam_mod
from vision_basedsensor_tpu.core.camera import CameraModel


def reconstruct_positions(cam: CameraModel, uv: jnp.ndarray,
                          axes_px: jnp.ndarray, valid: jnp.ndarray,
                          cfg: ReconstructConfig) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Pixel observations -> world positions.

    Args:
      uv: ``(..., 2)`` distorted pixel centers (Cx, Cy).
      axes_px: ``(..., 2)`` observed (major, minor) axes; depth uses the
        major axis like the reference (``3d_reconstruction.py:209``).
      valid: ``(...,)`` observation mask.

    Applies the reference's gates: markers smaller than
    ``min_marker_size_px`` are dropped (``3d_reconstruction.py:173-176``) and
    positions must be finite (:231-232). The reference additionally rejects
    markers within 1e-6 px of the principal point (:216-217) — that gate is
    NOT replicated: the depth formula has no singularity at R = 0
    (d_eff = D there), and an exactly-centered marker is a legitimate
    observation (the apex marker sits on the axis by design).

    One gate the reference does NOT have: ``max_axis_ratio``. A marker
    half-covered by debris still yields a well-formed moment ellipse whose
    measured major axis is badly biased — measured: a half-occluded marker
    passed every reference gate and fabricated a 13.9 mm displacement. A
    half-disk's moment ellipse has major/minor ~ 1.9 while legitimate dome
    markers stay below ~1.4 under compression + tilt, so eccentric
    observations drop for the frame (per-marker continue-on-failure
    semantics, 3d_reconstruction.py:309-311).

    Returns (world positions ``(..., 3)``, updated validity).
    """
    diameter_px = axes_px[..., 0]
    # One undistortion fixed point serves both consumers: pixel-space
    # centers for back-projection and (below) normalized coords for the
    # distortion-magnification Jacobian — the 5-iteration Newton loop is
    # the stage's hot op and used to run twice.
    xy_n = cam_mod.undistort_points(cam, uv, iters=cfg.undistort_iters,
                                    to_pixels=False)
    uv_u = cam_mod.normalized_to_pixel(cam, xy_n)
    ok = valid & (diameter_px >= cfg.min_marker_size_px)
    if cfg.max_axis_ratio is not None:
        ratio = diameter_px / jnp.maximum(axes_px[..., 1], 1e-6)
        ok = ok & (ratio <= cfg.max_axis_ratio)

    if cfg.distortion_corrected_diameter:
        # The reference measures diameters in the DISTORTED image but never
        # compensates (it undistorts only the centers,
        # 3d_reconstruction.py:259-260 + :220) — with a typical endoscopic
        # barrel lens that biases off-center depths by up to ~10%. Correct
        # each diameter by the local isotropic magnification of the
        # distortion map, sqrt(|det d(distorted)/d(undistorted)|), evaluated
        # at the undistorted point via autodiff.
        jac = jax.vmap(jax.jacfwd(lambda p: cam_mod.distort_normalized(cam, p)))(
            xy_n.reshape(-1, 2))
        det = jnp.abs(jac[:, 0, 0] * jac[:, 1, 1] - jac[:, 0, 1] * jac[:, 1, 0])
        mag = jnp.sqrt(jnp.maximum(det, 1e-12)).reshape(diameter_px.shape)
        diameter_px = diameter_px / mag

    world = cam_mod.backproject_depth_from_diameter(
        cam, uv_u, diameter_px, cfg.marker_diameter_mm)
    ok = ok & jnp.all(jnp.isfinite(world), axis=-1)
    return jnp.where(ok[..., None], world, 0.0), ok
