"""Synthetic dome renderer: the framework's test backbone.

The reference has no automated tests; its quality assurance is physical
experiments (SURVEY.md §4) — a 12x0.7 mm probe-indentation staircase
(README.md:103-121) and a 15 deg tilted-compression pose (README.md:146).
This module turns those experiments into synthetic fixtures: it renders the
known 65-marker dome (layout.py) through the full pinhole+distortion camera
model with prescribed per-marker world displacements, giving exact ground
truth for centroids, diameters, 3D displacement fields, and tilt angles.

Rendering is pure JAX: each marker disk is projected through the camera's
local Jacobian into an image-plane ellipse and rasterized with ~1 px
anti-aliased edges; per-pixel cost is a masked min over 65 markers, which
XLA fuses into a single elementwise pass.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vision_basedsensor_tpu import layout
from vision_basedsensor_tpu.core import camera as cam_mod
from vision_basedsensor_tpu.core.camera import CameraModel


class DomeScene(NamedTuple):
    cam: CameraModel
    marker_world: jnp.ndarray   # (65, 3) rest positions, mm
    marker_radius_mm: float
    background: float           # gray level of the bonnet surface
    marker_level: float         # gray level inside markers
    height: int
    width: int


def default_scene(height: int = 480, width: int = 640,
                  camera_z_mm: float | None = None,
                  dist: np.ndarray | None = None) -> DomeScene:
    """Camera under the dome apex looking up (+Z), dome at the origin.

    Mirrors the physical arrangement: endoscopic camera inside the bonnet
    tool viewing the marker-printed inner surface (README.md:7). The camera
    distance scales with resolution so marker images stay ~20 px across —
    the size the detector's resolution profiles (and the reference's
    constants) are tuned for.
    """
    if camera_z_mm is None:
        # Small frames move the camera closer so markers stay ~20 px (the
        # low-res profile's sweet spot); above 640 px the distance stays
        # fixed so markers grow with resolution, matching the reference's
        # high-res profile constants (blur 101, template ~81 expect ~2x
        # larger blobs at >480 rows).
        camera_z_mm = -40.0 * min(width / 640.0, 1.0)
    f = 0.625 * width  # outer ring (r=16.29 @ depth ~45) stays inside the frame
    cam = CameraModel.create(
        fx=f, fy=f, cx=width / 2, cy=height / 2,
        dist=np.zeros(5) if dist is None else dist,
        R_wc=np.eye(3), T_wc=np.array([0.0, 0.0, -camera_z_mm]),
    )
    table = layout.dome_layout()
    return DomeScene(
        cam=cam,
        marker_world=jnp.asarray(table[:, 1:], jnp.float32),
        marker_radius_mm=layout.MARKER_DIAMETER_MM / 2,
        background=190.0,
        marker_level=40.0,
        height=height,
        width=width,
    )


def _projection_jacobian(cam: CameraModel, p_world: jnp.ndarray) -> jnp.ndarray:
    """d(pixel)/d(world) ``(..., 2, 3)`` at the given world points."""
    def proj(p):
        return cam_mod.project_points(cam, p)
    flat = p_world.reshape(-1, 3)
    J = jax.vmap(jax.jacfwd(proj))(flat)
    return J.reshape(p_world.shape[:-1] + (2, 3))


def render_frames(scene: DomeScene, displacements: jnp.ndarray,
                  marker_mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """Render frames for per-marker world displacements ``(B, 65, 3)`` (mm).

    Each marker is a ball of radius ``marker_radius_mm`` (its image carries
    the same radial foreshortening the reference's depth model inverts,
    3d_reconstruction.py:219). Returns float frames ``(B, H, W)`` in 0..255.
    """
    if displacements.ndim == 2:
        displacements = displacements[None]
    if marker_mask is None:
        marker_mask = jnp.ones((scene.marker_world.shape[0],), bool)
    return _render_impl(scene.cam, scene.marker_world, displacements,
                        marker_mask, scene.marker_radius_mm, scene.background,
                        scene.marker_level, height=scene.height,
                        width=scene.width)


@functools.partial(jax.jit, static_argnames=("height", "width"))
def _render_impl(cam, marker_world, displacements, marker_mask,
                 marker_radius_mm, background, marker_level,
                 *, height: int, width: int) -> jnp.ndarray:
    pos = marker_world[None] + displacements  # (B, 65, 3)

    uv = cam_mod.project_points(cam, pos)                       # (B, 65, 2)
    J = _projection_jacobian(cam, pos)                          # (B, 65, 2, 3)
    # Image of the marker ball: ellipse with shape matrix M = (r^2 J J^T)^-1.
    JJt = jnp.einsum("...ij,...kj->...ik", J, J,
                     precision=jax.lax.Precision.HIGHEST) * marker_radius_mm**2
    Minv = jnp.linalg.inv(JJt + 1e-9 * jnp.eye(2, dtype=JJt.dtype))  # (B, 65, 2, 2)
    # Effective pixel radius (geometric mean) for anti-aliasing width.
    r_px = jnp.sqrt(jnp.sqrt(jnp.linalg.det(JJt)))

    ys = jnp.arange(height, dtype=jnp.float32)
    xs = jnp.arange(width, dtype=jnp.float32)
    gx, gy = jnp.meshgrid(xs, ys)                               # (H, W)
    scene = DomeScene(cam, marker_world, marker_radius_mm, background,
                      marker_level, height, width)

    def frame(args):
        uv_f, Minv_f, r_f = args
        def add_marker(cover, xs):
            c, M, r, on = xs
            d0 = gx - c[0]
            d1 = gy - c[1]
            m = (M[0, 0] * d0 * d0 + 2.0 * M[0, 1] * d0 * d1 + M[1, 1] * d1 * d1)
            # Signed distance to the ellipse boundary in px ~ (sqrt(m)-1)*r.
            sd = (jnp.sqrt(jnp.maximum(m, 1e-12)) - 1.0) * r
            alpha = jnp.clip(0.5 - sd, 0.0, 1.0).astype(cover.dtype)
            return cover + jnp.where(on, alpha, 0.0), None

        # Accumulate coverage marker-by-marker (scan) so the peak memory is
        # one (H, W) buffer, not (65, H, W) — essential for large batches.
        cover, _ = jax.lax.scan(add_marker, jnp.zeros_like(gx),
                                (uv_f, Minv_f, r_f, marker_mask))
        cover = jnp.clip(cover, 0.0, 1.0)
        return scene.background + cover * (scene.marker_level - scene.background)

    img = jax.lax.map(frame, (uv, Minv, r_px), batch_size=8)
    return jnp.clip(jnp.floor(img + 0.5), 0.0, 255.0)


def indentation_staircase(num_steps: int = 12, step_mm: float = 0.7,
                          frames_per_step: int = 1) -> jnp.ndarray:
    """World displacement sequence replicating the probe-indentation
    experiment (README.md:103-121): every marker translates by k * step_mm
    along -Z at step k. Returns ``(num_steps*frames_per_step + 1, 65, 3)``
    including the rest frame."""
    steps = jnp.arange(num_steps + 1, dtype=jnp.float32) * step_mm
    steps = jnp.repeat(steps, jnp.where(jnp.arange(num_steps + 1) == 0, 1, frames_per_step),
                       total_repeat_length=1 + num_steps * frames_per_step)
    d = jnp.zeros((steps.shape[0], layout.NUM_MARKERS, 3), jnp.float32)
    return d.at[:, :, 2].set(-steps[:, None])


def probe_indentation_field(depth_mm: float, contact_xy=(0.0, 0.0),
                            probe_radius_mm: float = 5.0) -> jnp.ndarray:
    """Local deformation of a spherical probe pressed into the dome.

    Physical analog of the reference's indentation rig (README.md:103-121):
    markers inside the contact footprint follow the probe surface; outside it
    the displacement decays smoothly (exponential skirt), instead of the
    rigid -Z translation of :func:`indentation_staircase`. Returns ``(65, 3)``
    -Z displacements (membrane tangential motion neglected).
    """
    table = layout.dome_layout()
    r = np.hypot(table[:, 1] - contact_xy[0], table[:, 2] - contact_xy[1])
    # Spherical probe cap: depth profile d(r) = depth - (R - sqrt(R^2 - r^2)).
    inside = r < probe_radius_mm
    sag = probe_radius_mm - np.sqrt(np.maximum(probe_radius_mm**2 - r**2, 0.0))
    d_in = np.maximum(depth_mm - sag, 0.0)
    # Footprint edge: radius where the probe meets the surface.
    a = probe_radius_mm * np.sqrt(max(0.0, 1 - (1 - depth_mm / probe_radius_mm)**2)) \
        if depth_mm < probe_radius_mm else probe_radius_mm
    edge = np.maximum(depth_mm - (probe_radius_mm - np.sqrt(max(probe_radius_mm**2 - a**2, 0.0))), 0.0)
    skirt = edge * np.exp(-(r - a) / max(probe_radius_mm, 1e-6))
    dz = np.where(inside, d_in, skirt)
    out = np.zeros((layout.NUM_MARKERS, 3), np.float32)
    out[:, 2] = -dz
    return jnp.asarray(out)


def membrane_indentation_field(depth_mm: float, contact_xy=(0.0, 0.0),
                               probe_radius_mm: float = 5.0,
                               tangential_frac: float = 0.3) -> jnp.ndarray:
    """Probe indentation with membrane kinematics: normal sag PLUS radial
    tangential flow.

    :func:`probe_indentation_field` models the rig's -Z sag only
    (README.md:103-121); a real elastomer membrane also stretches — material
    under the probe is pushed radially outward, so markers translate in X/Y
    too. Modeled as an axisymmetric outward flow that vanishes at the
    contact centre, peaks at the contact edge ``r = a``, and decays outside:

        u_r(r) = tangential_frac * depth * (r/a) * exp((1 - (r/a)^2) / 2)

    (peak value ``tangential_frac * depth`` at ``r = a``; the Gaussian-decay
    shape is the standard far-field of a point indentation on a stretched
    membrane). This stresses full 3D displacement recovery — the reference
    only ever validates Z (its rig prescribes pure -Z steps) while its
    output schema carries dX/dY/dZ (``3d_reconstruction.py:296-307``).
    Returns ``(65, 3)`` world displacements (mm).
    """
    dz = np.asarray(probe_indentation_field(depth_mm, contact_xy,
                                            probe_radius_mm))
    table = layout.dome_layout()
    rx = table[:, 1] - contact_xy[0]
    ry = table[:, 2] - contact_xy[1]
    r = np.hypot(rx, ry)
    a = max(probe_radius_mm * np.sqrt(
        max(0.0, 1 - (1 - depth_mm / probe_radius_mm) ** 2)), 1e-6) \
        if depth_mm < probe_radius_mm else probe_radius_mm
    u_r = tangential_frac * depth_mm * (r / a) * np.exp(0.5 * (1 - (r / a) ** 2))
    safe_r = np.maximum(r, 1e-9)
    out = np.stack([u_r * rx / safe_r, u_r * ry / safe_r, dz[:, 2]], axis=-1)
    return jnp.asarray(out.astype(np.float32))


def tilt_deviation_field(tilt_deg: float, axis: str = "y",
                         compression_mm: float = 1.0) -> jnp.ndarray:
    """Displacement field of a tilted compression: each marker moves along -Z
    by ``compression + tan(tilt) * coordinate`` — so the deviation field's
    fitted contact plane has exactly ``tilt_deg`` tilt
    (ForceDistribution.py:138-162 semantics). Returns ``(65, 3)``."""
    table = layout.dome_layout()
    coord = table[:, 1] if axis == "y" else table[:, 2]
    dz = -(compression_mm + np.tan(np.deg2rad(tilt_deg)) * coord)
    d = np.zeros((layout.NUM_MARKERS, 3), np.float32)
    d[:, 2] = dz
    return jnp.asarray(d)
