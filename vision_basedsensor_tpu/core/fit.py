"""Masked least-squares fits and moment-based shape estimation.

Replaces the reference's ``np.linalg.lstsq`` plane fit
(``ForceDistribution.py:138-162``) and contour-based ``cv2.fitEllipse``
(``marker_detection.py:208``) with fixed-shape, mask-aware formulations that
jit/vmap cleanly.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


def masked_mean(x: jnp.ndarray, mask: jnp.ndarray, axis=None, keepdims=False) -> jnp.ndarray:
    m = mask.astype(x.dtype)
    num = jnp.sum(x * m, axis=axis, keepdims=keepdims)
    den = jnp.maximum(jnp.sum(m, axis=axis, keepdims=keepdims), 1e-12)
    return num / den


def masked_lstsq(A: jnp.ndarray, b: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Solve ``min ||A x - b||`` over rows where ``mask`` is set.

    ``A: (..., N, P)``, ``b: (..., N)``, ``mask: (..., N)`` -> ``(..., P)``.
    Uses the normal equations with a tiny Tikhonov term for rank safety —
    fixed shapes, no data-dependent control flow.
    """
    m = mask.astype(A.dtype)[..., None]
    Am = A * m
    # Normal equations square the condition number; TF32 products would
    # move the fitted plane (and the tilt read from it) visibly.
    hp = jax.lax.Precision.HIGHEST
    AtA = jnp.einsum("...np,...nq->...pq", Am, A, precision=hp)
    Atb = jnp.einsum("...np,...n->...p", Am, b, precision=hp)
    eye = jnp.eye(A.shape[-1], dtype=A.dtype)
    # [..., None]/[..., 0]: batched matrix-vector solve (jnp.linalg.solve
    # treats a (..., N) rhs as a stack of matrices since JAX 0.5).
    return jnp.linalg.solve(AtA + 1e-9 * eye, Atb[..., None])[..., 0]


class PlaneFit(NamedTuple):
    a: jnp.ndarray
    b: jnp.ndarray
    c: jnp.ndarray
    tilt_deg: jnp.ndarray


def fit_plane(xyz: jnp.ndarray, mask: jnp.ndarray | None = None) -> PlaneFit:
    """Least-squares plane ``Z = aX + bY + c`` and its tilt angle.

    Reproduces ``ForceDistribution.fit_plane_least_squares``
    (``ForceDistribution.py:138-162``): tilt = atan(sqrt(a^2 + b^2)) in
    degrees — the paper's pose-misalignment output (README.md:124).

    ``xyz: (..., N, 3)``; optional validity ``mask: (..., N)``.
    """
    if mask is None:
        mask = jnp.ones(xyz.shape[:-1], dtype=bool)
    ones = jnp.ones_like(xyz[..., 0])
    A = jnp.stack([xyz[..., 0], xyz[..., 1], ones], axis=-1)
    coeff = masked_lstsq(A, xyz[..., 2], mask)
    a, b, c = coeff[..., 0], coeff[..., 1], coeff[..., 2]
    tilt = jnp.degrees(jnp.arctan(jnp.sqrt(a * a + b * b)))
    return PlaneFit(a, b, c, tilt)


def fit_plane_robust(xyz: jnp.ndarray, mask: jnp.ndarray | None = None,
                     iters: int = 3, tukey_c: float = 4.685) -> PlaneFit:
    """IRLS plane fit with Tukey biweight: gross outlier markers (merged
    blobs, occlusion-completed low-confidence detections, markers driven
    outside the measurement regime) get downweighted instead of levering
    the tilt — measured: a 20 deg tilt whose two extreme cardinal markers
    reconstruct with mm-level errors fits to 21.7 deg plain vs 20.0 robust.

    Fixed iteration count and masked math only (jit/vmap-clean). The
    robustness scale is the MAD of the residuals (1.4826 x masked median);
    with well-behaved residuals the weights are ~1 and the result matches
    :func:`fit_plane` to numerical noise. ``fit_plane`` (the reference's
    exact ``np.linalg.lstsq`` semantics, ForceDistribution.py:138-162)
    stays available via ``AnalysisConfig.robust_plane_fit=False``.
    """
    if mask is None:
        mask = jnp.ones(xyz.shape[:-1], dtype=bool)
    ones = jnp.ones_like(xyz[..., 0])
    A = jnp.stack([xyz[..., 0], xyz[..., 1], ones], axis=-1)
    z = xyz[..., 2]
    w = mask.astype(z.dtype)
    coeff = masked_lstsq(A, z, w)
    for _ in range(iters):
        r = jnp.einsum("...np,...p->...n", A, coeff,
                       precision=jax.lax.Precision.HIGHEST) - z
        absr = jnp.where(mask, jnp.abs(r), jnp.nan)
        med = jnp.nanmedian(absr, axis=-1, keepdims=True)
        # An all-False mask (fully occluded frame, empty common-id set)
        # makes the median NaN; NaN weights would poison the solve into a
        # NaN tilt where the plain fit returns the finite Tikhonov zero —
        # and the live publisher would then emit non-JSON 'NaN' tokens.
        scale = jnp.maximum(1.4826 * jnp.nan_to_num(med, nan=1.0), 1e-6)
        u = jnp.clip(r / (tukey_c * scale), -1.0, 1.0)
        w = mask.astype(z.dtype) * (1.0 - u * u) ** 2
        coeff = masked_lstsq(A, z, w)
    a, b, c = coeff[..., 0], coeff[..., 1], coeff[..., 2]
    tilt = jnp.degrees(jnp.arctan(jnp.sqrt(a * a + b * b)))
    return PlaneFit(a, b, c, tilt)


class EllipseMoments(NamedTuple):
    """Ellipse parameters recovered from second-order region moments."""
    center: jnp.ndarray  # (..., 2) (x, y)
    major: jnp.ndarray   # full major axis length
    minor: jnp.ndarray   # full minor axis length
    angle_deg: jnp.ndarray  # major-axis angle, degrees in [0, 180)
    area: jnp.ndarray    # zeroth moment (pixel count for binary weights)


def ellipse_from_moments(weights: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray) -> EllipseMoments:
    """Fit an ellipse to a weighted pixel region via central moments.

    Fixed-shape replacement for ``cv2.findContours`` + ``cv2.fitEllipse``
    (``marker_detection.py:196-217``): for a filled ellipse of semi-axes
    (p, q) the covariance eigenvalues are p^2/4 and q^2/4, so the full axes
    are ``4 sqrt(eig)``. Works on any broadcastable ``(..., N)`` weights with
    matching pixel coordinates.
    """
    w = weights
    total = jnp.maximum(jnp.sum(w, axis=-1), 1e-12)
    mx = jnp.sum(w * x, axis=-1) / total
    my = jnp.sum(w * y, axis=-1) / total
    dx = x - mx[..., None]
    dy = y - my[..., None]
    mxx = jnp.sum(w * dx * dx, axis=-1) / total
    myy = jnp.sum(w * dy * dy, axis=-1) / total
    mxy = jnp.sum(w * dx * dy, axis=-1) / total
    # Closed-form 2x2 symmetric eigendecomposition.
    tr = mxx + myy
    diff = mxx - myy
    disc = jnp.sqrt(jnp.maximum(diff * diff + 4.0 * mxy * mxy, 0.0))
    lam1 = 0.5 * (tr + disc)  # major
    lam2 = 0.5 * (tr - disc)  # minor
    angle = 0.5 * jnp.arctan2(2.0 * mxy, diff)  # radians, major-axis direction
    angle_deg = jnp.mod(jnp.degrees(angle), 180.0)
    return EllipseMoments(
        center=jnp.stack([mx, my], axis=-1),
        major=4.0 * jnp.sqrt(jnp.maximum(lam1, 0.0)),
        minor=4.0 * jnp.sqrt(jnp.maximum(lam2, 0.0)),
        angle_deg=angle_deg,
        area=total,
    )
