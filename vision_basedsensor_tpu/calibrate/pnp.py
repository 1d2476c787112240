"""Extrinsic calibration: batched-hypothesis RANSAC PnP (reference C11).

Replaces ``cv2.solvePnPRansac(SOLVEPNP_ITERATIVE, conf=0.99, err=8px,
iters=1000)`` (``extrinsic_calibration.py:97-106``) with a fixed-shape
formulation: all RANSAC hypotheses are one batch axis — minimal 6-point DLT
solves as a vmapped SVD, inlier counting as one matrix op, then fixed-
iteration Gauss-Newton refinement on the best hypothesis's inliers (the
"ITERATIVE" part). Deterministic given the PRNG key.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from vision_basedsensor_tpu.config import CalibrateConfig
from vision_basedsensor_tpu.core import camera as cam_mod
from vision_basedsensor_tpu.core.camera import CameraModel
from vision_basedsensor_tpu.core.transforms import inverse_rodrigues, rodrigues
from vision_basedsensor_tpu.utils.precision import with_x64


class PnPResult(NamedTuple):
    R_wc: jnp.ndarray             # (3, 3)
    T_wc: jnp.ndarray             # (3,)
    inliers: jnp.ndarray          # (N,) bool
    num_inliers: jnp.ndarray
    mean_reproj_error: jnp.ndarray  # over ALL points (extrinsic_calibration.py:117-118)
    # Post-hoc RANSAC confidence 1 - (1 - w^6)^n_hyp from the final inlier
    # ratio w: the probability the fixed hypothesis batch contained at least
    # one all-inlier sample. cv2 uses cfg.ransac_confidence to adapt its
    # iteration count at runtime; the batched formulation runs a fixed batch, so
    # the knob is honored by *verifying* the achieved confidence instead
    # (solve_pnp_ransac warns when it falls short).
    achieved_confidence: jnp.ndarray


def _dlt_pnp(obj: jnp.ndarray, img_norm: jnp.ndarray):
    """Minimal DLT solve for P = [R|t] from >= 6 normalized correspondences."""
    X, Y, Z = obj[:, 0], obj[:, 1], obj[:, 2]
    u, v = img_norm[:, 0], img_norm[:, 1]
    one = jnp.ones_like(X)
    zero = jnp.zeros_like(X)
    r1 = jnp.stack([X, Y, Z, one, zero, zero, zero, zero, -u * X, -u * Y, -u * Z, -u], -1)
    r2 = jnp.stack([zero, zero, zero, zero, X, Y, Z, one, -v * X, -v * Y, -v * Z, -v], -1)
    A = jnp.concatenate([r1, r2], axis=0)
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    P = vt[-1].reshape(3, 4)
    # Fix scale/sign: ||R rows|| = 1, points in front (positive depth).
    Rraw = P[:, :3]
    scale = jnp.cbrt(jnp.abs(jnp.linalg.det(Rraw)))
    sgn = jnp.sign(jnp.mean(obj @ Rraw[2] + P[2, 3]))
    P = P * sgn / jnp.maximum(scale, 1e-12)
    u_, _, vt_ = jnp.linalg.svd(P[:, :3])
    R = u_ @ vt_
    t = P[:, 3]
    return R, t


def _reproj_error(cam: CameraModel, R, t, obj, img_px):
    c = cam._replace(R_wc=R, T_wc=t)
    proj = cam_mod.project_points(c, obj)
    return jnp.linalg.norm(proj - img_px, axis=-1)


def _gauss_newton(cam: CameraModel, R0, t0, obj, img_px, weights, iters: int):
    rv0 = inverse_rodrigues(R0)

    def residuals(p):
        c = cam._replace(R_wc=rodrigues(p[:3]), T_wc=p[3:])
        r = (cam_mod.project_points(c, obj) - img_px) * weights[:, None]
        return r.reshape(-1)

    def step(p, _):
        rsd = residuals(p)
        J = jax.jacfwd(residuals)(p)
        dp, *_ = jnp.linalg.lstsq(J, rsd, rcond=None)
        return p - dp, None

    p0 = jnp.concatenate([rv0, t0])
    p, _ = jax.lax.scan(step, p0, None, length=iters)
    return rodrigues(p[:3]), p[3:]


@with_x64
def solve_pnp_ransac(object_points: jnp.ndarray, image_points: jnp.ndarray,
                     cam: CameraModel, cfg: CalibrateConfig,
                     key: jax.Array | int = 0) -> PnPResult:
    """RANSAC + iterative refinement PnP.

    Args:
      object_points: ``(N, 3)`` world points (e.g. CMM-measured markers,
        ``extrinsic_calibration.py:276-288``).
      image_points: ``(N, 2)`` distorted pixel observations.
      cam: camera with intrinsics + distortion set.
    """
    obj = jnp.asarray(object_points, jnp.float64)
    img = jnp.asarray(image_points, jnp.float64)
    n = obj.shape[0]
    if isinstance(key, int):
        key = jax.random.PRNGKey(key)

    # Normalized (undistorted) coordinates for the DLT solves.
    img_norm = cam_mod.undistort_points(cam, img, iters=10, to_pixels=False)

    # COPLANAR world points (markers measured on a flat plate — a standard
    # calibration rig) make every 6-point DLT rank-deficient: the general
    # solver returned an all-NaN pose (round-3 review, confirmed by
    # execution; cv2's ITERATIVE handles planar targets). Route them
    # through 4-point homography hypotheses + the Zhang homography->pose
    # decomposition composed with the plane basis instead. Host-side
    # branch: this function is eager.
    centroid = obj.mean(axis=0)
    _, s_sv, vt_sv = jnp.linalg.svd(obj - centroid, full_matrices=False)
    planar = float(s_sv[2]) < 1e-4 * max(float(s_sv[0]), 1e-12)
    m_min = 4 if planar else 6
    if n < m_min:
        raise ValueError(
            f"PnP needs at least {m_min} matched world/pixel marker "
            f"correspondences ({'planar' if planar else 'general'} target), "
            f"got {n}")

    n_hyp = cfg.ransac_iterations
    keys = jax.random.split(key, n_hyp)
    idx = jax.vmap(lambda k: jax.random.choice(k, n, (m_min,),
                                               replace=False))(keys)

    if planar:
        from vision_basedsensor_tpu.calibrate.zhang import (
            _extrinsics_from_homography, fit_homography)
        basis = vt_sv[:2].T                             # (3, 2) in-plane
        q = (obj - centroid) @ basis                    # (N, 2) plane coords
        eye3 = jnp.eye(3, dtype=obj.dtype)
        b3 = jnp.concatenate([basis, jnp.cross(basis[:, 0],
                                               basis[:, 1])[:, None]], axis=1)

        def hypothesis(i):
            H = fit_homography(q[i][None], img_norm[i][None])[0]
            R_p, t_p = _extrinsics_from_homography(eye3, H)
            # x_cam = R_wc(C + B q) + T_wc: R_wc = [r1 r2 r3] B^T.
            R = R_p @ b3.T
            t = t_p - R @ centroid
            err = _reproj_error(cam, R, t, obj, img)
            inl = err < cfg.ransac_reproj_threshold_px
            return inl.sum(), R, t
    else:
        def hypothesis(i):
            R, t = _dlt_pnp(obj[i], img_norm[i])
            err = _reproj_error(cam, R, t, obj, img)
            inl = err < cfg.ransac_reproj_threshold_px
            return inl.sum(), R, t

    scores, Rs, ts = jax.vmap(hypothesis)(idx)
    best = jnp.argmax(scores)
    R_b, t_b = Rs[best], ts[best]
    inl = _reproj_error(cam, R_b, t_b, obj, img) < cfg.ransac_reproj_threshold_px

    R, t = _gauss_newton(cam, R_b, t_b, obj, img,
                         inl.astype(obj.dtype), cfg.pnp_refine_iters)
    err_all = _reproj_error(cam, R, t, obj, img)
    inliers = err_all < cfg.ransac_reproj_threshold_px
    w = inliers.sum() / n
    achieved = 1.0 - (1.0 - jnp.clip(w, 0.0, 1.0) ** m_min) ** n_hyp
    if float(achieved) < cfg.ransac_confidence:  # eager host path; sync is fine
        import warnings
        warnings.warn(
            f"RANSAC achieved confidence {float(achieved):.4f} < requested "
            f"{cfg.ransac_confidence} (inlier ratio {float(w):.2f}, "
            f"{n_hyp} hypotheses); raise CalibrateConfig.ransac_iterations.",
            stacklevel=2)
    return PnPResult(
        R_wc=R, T_wc=t, inliers=inliers, num_inliers=inliers.sum(),
        mean_reproj_error=jnp.mean(err_all), achieved_confidence=achieved)
