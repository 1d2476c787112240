"""Per-peak window moment sums + finalization into marker candidates.

The detector's per-candidate stage reduces three image fields over a window
around each peak into 28 sums; everything downstream (centroids, ellipse
axes, validity gates) is closed-form in those sums. ``window_sums_xla``
produces them: gather patches with ``dynamic_slice`` and reduce (vmapped
XLA; on a GPU the gather is an ordinary indexed load).

Coordinates in the sums are RELATIVE to the peak (dx, dy in [-P/2, P/2]):
raw second moments around absolute pixel coordinates would lose ~5 digits to
cancellation in f32. ``finalize`` adds the peak positions back.

Sum layout (last axis, size 24):
  0:  band * cut                      (band-centroid denominator)
  1:  band * cut * dx    2: * dy      (band-centroid numerators)
  3:  area * cut                      (ellipse m00)
  4:  area * cut * dx    5: * dy
  6:  area * cut * dx^2  7: * dy^2  8: * dx*dy
  9:  w * cut            10: * dx  11: * dy
  12: w * cut * dx^2     13: * dy^2 14: * dx*dy
      (photometric soft moments; w = (hi - gray)/(hi - lo) clipped — soft
       weights give ~0.01 px centroids and clip-stable axes, but the soft
       skirt inflates axes ~3%)
  15: h * cut            16: * dx  17: * dy
  18: h * cut * dx^2     19: * dy^2 20: * dx*dy
      (half-level moments; h = (w >= 0.5) — the half-level boundary is the
       true marker edge for a symmetric profile: unbiased axes, but fragile
       when a neighbor halfplane clips the blob. finalize() combines both:
       soft axes rescaled by the per-frame median half/soft ratio.)
  21: min(gray) in cut   22: max(gray) in cut
  23: count(cut)
  24: w * cut * dx^3     25: * dx^2*dy  26: * dx*dy^2  27: * dy^3
      (photometric THIRD moments: a partially occluded marker is a censored
       disk whose intensity distribution is skewed along the cut normal —
       the skew identifies the occluded side so the true center/diameter
       can be completed from the visible half; see complete_occluded.)
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from vision_basedsensor_tpu.config import DetectProfile
from vision_basedsensor_tpu.ops.patches import extract_patches, patch_coords
from vision_basedsensor_tpu.ops.peaks import Peaks

NUM_SUMS = 28


def soft_weight_remap(w: jnp.ndarray, floor: float) -> jnp.ndarray:
    """Symmetric floor/saturation remap of soft weights (see
    ``DetectProfile.soft_floor``): maps ``[floor, 1-floor] -> [0, 1]``
    keeping the half-level point fixed. Zeroes the additive noise skirt
    (background pixels whose clipped ``w`` is positive purely from noise)
    that otherwise inflates soft second moments. Identity for ``floor<=0``."""
    if floor <= 0.0:
        return w
    return jnp.clip((w - floor) * (1.0 / (1.0 - 2.0 * floor)), 0.0, 1.0)


class CutGeometry(NamedTuple):
    """Per-peak isolation geometry: radial cutoff + 3 halfplanes."""
    ex: jnp.ndarray   # (K, 3) neighbor direction x
    ey: jnp.ndarray   # (K, 3)
    rhs: jnp.ndarray  # (K, 3) halfplane offsets (inf disables)


def cut_geometry(peaks: Peaks) -> CutGeometry:
    """Nearest-3-neighbor halfplane parameters for each peak.

    With fewer than 4 candidate slots there are fewer than 3 possible
    neighbors; missing halfplanes are disabled (rhs = inf) instead of
    letting ``top_k(k=3)`` crash at trace time for small ``max_candidates``
    configs."""
    k = peaks.xy.shape[0]
    n_hp = min(3, max(k - 1, 0))
    if n_hp == 0:
        inf = jnp.full((k, 3), jnp.inf)
        z = jnp.zeros((k, 3))
        return CutGeometry(ex=z, ey=z, rhs=inf)
    pd2 = jnp.sum((peaks.xy[:, None, :] - peaks.xy[None, :, :]) ** 2, axis=-1)
    pd2 = jnp.where(jnp.eye(k, dtype=bool) | ~peaks.valid[None, :], jnp.inf, pd2)
    _, nbr = jax.lax.top_k(-pd2, n_hp)
    nxy = peaks.xy[nbr]
    nok = jnp.isfinite(jnp.take_along_axis(pd2, nbr, axis=1))
    ex = nxy[..., 0] - peaks.xy[:, None, 0]
    ey = nxy[..., 1] - peaks.xy[:, None, 1]
    rhs = jnp.where(nok, 0.5 * (ex * ex + ey * ey), jnp.inf)
    pad = 3 - n_hp
    if pad:
        ex = jnp.pad(ex, ((0, 0), (0, pad)))
        ey = jnp.pad(ey, ((0, 0), (0, pad)))
        rhs = jnp.pad(rhs, ((0, 0), (0, pad)), constant_values=jnp.inf)
        nok = jnp.pad(nok, ((0, 0), (0, pad)))
    return CutGeometry(ex=jnp.where(nok, ex, 0.0), ey=jnp.where(nok, ey, 0.0),
                       rhs=rhs)


def window_sums_xla(band: jnp.ndarray, area: jnp.ndarray, gray: jnp.ndarray,
                    peaks: Peaks, geom: CutGeometry,
                    profile: DetectProfile) -> jnp.ndarray:
    """Patches + reductions. Returns ``(K, NUM_SUMS)``."""
    p = profile.patch_size
    b_patch, start = extract_patches(band, peaks.xy, p)
    a_patch, _ = extract_patches(area, peaks.xy, p)
    g_patch, _ = extract_patches(gray, peaks.xy, p)
    gx, gy = patch_coords(start, p)

    dx = gx - peaks.xy[:, 0, None, None]
    dy = gy - peaks.xy[:, 1, None, None]
    d2 = dx * dx + dy * dy
    lhs = (dx[:, None] * geom.ex[:, :, None, None]
           + dy[:, None] * geom.ey[:, :, None, None])
    keep = jnp.all(lhs <= geom.rhs[:, :, None, None] + 1e-3, axis=1)
    cut = ((d2 <= profile.radial_cutoff_px**2) & keep).astype(jnp.float32)

    flat = lambda v: v.reshape(-1, p * p)
    fx, fy, c = flat(dx), flat(dy), flat(cut)
    fb, fa, fg = flat(b_patch) * c, flat(a_patch) * c, flat(g_patch)

    inside = c > 0
    lo = jnp.min(jnp.where(inside, fg, jnp.inf), axis=-1)
    hi = jnp.max(jnp.where(inside, fg, -jnp.inf), axis=-1)
    contrast = jnp.maximum(hi - lo, 1e-3)
    w = jnp.clip((hi[:, None] - fg) / contrast[:, None], 0.0, 1.0)
    w = soft_weight_remap(w, profile.soft_floor) * c

    def m(v):
        return jnp.stack([v.sum(-1), (v * fx).sum(-1), (v * fy).sum(-1)], -1)

    def m2(v):
        return jnp.stack([(v * fx * fx).sum(-1), (v * fy * fy).sum(-1),
                          (v * fx * fy).sum(-1)], -1)

    def m3(v):
        return jnp.stack([(v * fx * fx * fx).sum(-1),
                          (v * fx * fx * fy).sum(-1),
                          (v * fx * fy * fy).sum(-1),
                          (v * fy * fy * fy).sum(-1)], -1)

    wh = (w >= 0.5).astype(jnp.float32)
    return jnp.concatenate([
        m(fb), m(fa), m2(fa), m(w), m2(w), m(wh), m2(wh),
        lo[:, None], hi[:, None], c.sum(-1)[:, None], m3(w),
    ], axis=-1)


class Finalized(NamedTuple):
    band_center: jnp.ndarray   # (K, 2)
    photo_center: jnp.ndarray  # (K, 2)
    area_center: jnp.ndarray   # (K, 2)
    area_axes: jnp.ndarray     # (K, 2) major, minor
    area_angle: jnp.ndarray    # (K,)
    photo_axes: jnp.ndarray    # (K, 2)
    photo_angle: jnp.ndarray   # (K,)
    area_m0: jnp.ndarray       # (K,)
    axis_scale: jnp.ndarray    # () half/soft calibration scalar actually applied
    minor_dir: jnp.ndarray     # (K, 2) photometric minor-axis unit vector,
    #                            oriented toward positive skew (the visible
    #                            side of a censored disk)
    skew: jnp.ndarray          # (K,) |standardized third moment| along it


def _ellipse(m0, mx, my, mxx, myy, mxy):
    tot = jnp.maximum(m0, 1e-12)
    cx = mx / tot
    cy = my / tot
    vxx = mxx / tot - cx * cx
    vyy = myy / tot - cy * cy
    vxy = mxy / tot - cx * cy
    tr = vxx + vyy
    diff = vxx - vyy
    disc = jnp.sqrt(jnp.maximum(diff * diff + 4.0 * vxy * vxy, 0.0))
    major = 4.0 * jnp.sqrt(jnp.maximum(0.5 * (tr + disc), 0.0))
    minor = 4.0 * jnp.sqrt(jnp.maximum(0.5 * (tr - disc), 0.0))
    angle = jnp.mod(jnp.degrees(0.5 * jnp.arctan2(2.0 * vxy, diff)), 180.0)
    return jnp.stack([cx, cy], -1), major, minor, angle


def finalize(sums: jnp.ndarray, peak_xy: jnp.ndarray,
             valid: jnp.ndarray | None = None,
             axis_scale: jnp.ndarray | None = None) -> Finalized:
    """Closed-form candidate geometry from the 24 window sums (peak-relative
    coordinates; centers are shifted back by ``peak_xy``).

    Photometric axes: soft-moment axes (clip-stable) rescaled by the
    half-level/soft major-axis ratio — the soft skirt's ~3% inflation is
    uniform across markers, the half-level estimate is unbiased where blobs
    are unclipped, and a single robust scalar transfers that calibration to
    every marker (including clipped ones).

    ``axis_scale``: pass the scalar to apply (normally the one measured on
    the session's frame 0, carried in ReferenceMarkers.axis_scale) — this
    makes diameters/depths independent of how frames are batched or chunked.
    With ``None`` the scale is the median ratio over ``valid`` candidates of
    THIS batch (the right choice only for self-contained one-shot calls,
    e.g. the frame-0 prologue that measures the scale in the first place).
    """
    s = sums
    bc = jnp.stack([s[..., 1], s[..., 2]], -1) / jnp.maximum(s[..., 0:1], 1e-12)
    ac, a_major, a_minor, a_angle = _ellipse(s[..., 3], s[..., 4], s[..., 5],
                                             s[..., 6], s[..., 7], s[..., 8])
    pc, p_major, p_minor, p_angle = _ellipse(s[..., 9], s[..., 10], s[..., 11],
                                             s[..., 12], s[..., 13], s[..., 14])
    _, h_major, _, _ = _ellipse(s[..., 15], s[..., 16], s[..., 17],
                                s[..., 18], s[..., 19], s[..., 20])

    if axis_scale is None:
        ratio = jnp.where((p_major > 1.0) & (h_major > 1.0) &
                          (jnp.ones_like(p_major, bool) if valid is None else valid),
                          h_major / jnp.maximum(p_major, 1e-9), jnp.nan)
        scale = jnp.nanmedian(ratio)  # one scalar across the whole batch
        scale = jnp.where(jnp.isfinite(scale), jnp.clip(scale, 0.9, 1.05), 1.0)
    else:
        scale = jnp.asarray(axis_scale, p_major.dtype)
    p_major = p_major * scale
    p_minor = p_minor * scale

    # Photometric minor-axis direction + standardized skew along it (the
    # censored-disk occlusion signature; complete_occluded consumes these).
    tot = jnp.maximum(s[..., 9], 1e-12)
    cx = s[..., 10] / tot
    cy = s[..., 11] / tot
    vxx = s[..., 12] / tot - cx * cx
    vyy = s[..., 13] / tot - cy * cy
    vxy = s[..., 14] / tot - cx * cy
    # Central third moments from the peak-relative raw moments.
    mu30 = s[..., 24] / tot - 3 * cx * (s[..., 12] / tot) + 2 * cx ** 3
    mu21 = (s[..., 25] / tot - 2 * cx * (s[..., 14] / tot)
            - cy * (s[..., 12] / tot) + 2 * cx * cx * cy)
    mu12 = (s[..., 26] / tot - 2 * cy * (s[..., 14] / tot)
            - cx * (s[..., 13] / tot) + 2 * cx * cy * cy)
    mu03 = s[..., 27] / tot - 3 * cy * (s[..., 13] / tot) + 2 * cy ** 3
    phi = 0.5 * jnp.arctan2(2.0 * vxy, vxx - vyy)   # major-axis angle
    ux = -jnp.sin(phi)                               # minor-axis direction
    uy = jnp.cos(phi)
    lam_u = jnp.maximum((p_minor / (4.0 * scale)) ** 2, 1e-12)
    mu3_u = (mu30 * ux ** 3 + 3 * mu21 * ux * ux * uy
             + 3 * mu12 * ux * uy * uy + mu03 * uy ** 3)
    flip = jnp.sign(jnp.where(mu3_u == 0, 1.0, mu3_u))
    minor_dir = jnp.stack([ux * flip, uy * flip], -1)
    skew = jnp.abs(mu3_u) / lam_u ** 1.5

    return Finalized(
        band_center=bc + peak_xy, photo_center=pc + peak_xy,
        area_center=ac + peak_xy,
        area_axes=jnp.stack([a_major, a_minor], -1), area_angle=a_angle,
        photo_axes=jnp.stack([p_major, p_minor], -1), photo_angle=p_angle,
        area_m0=s[..., 3], axis_scale=scale, minor_dir=minor_dir, skew=skew)


@functools.lru_cache(maxsize=1)
def _occlusion_polys():
    """Censored-disk inversion as polynomials in ``log(axis ratio)``.

    Numeric quadrature over the along-normal density ``f(u) = 2 sqrt(1-u²)``
    of the unit disk censored to ``u >= s`` yields, per censoring depth:
    the observable axis ratio ``sqrt(lam_v/lam_u)`` (monotonic in s — the
    inversion key), the centroid shift ``E[u]`` toward the visible side,
    and ``sqrt(lam_v)`` (the along-chord spread that calibrates the
    radius). Both inversion curves are smooth in ``log(ratio)``, so a
    degree-7 least-squares fit reproduces them to <= 3.3e-4 absolute
    (sub-millipixel at any real marker radius) — and Horner evaluation is
    plain elementwise math that fuses into its neighbours, where
    ``jnp.interp``'s searchsorted+take lowers to per-element gathers.

    Returns float tuples (shift_coeffs, sqlv_coeffs) highest-degree first,
    valid for ratio in [1.003, 8.43] (clamp before evaluating).
    """
    # np.trapezoid is the NumPy >= 2.0 name of np.trapz; support both
    # (pyproject declares an unpinned numpy and this runs on the DEFAULT
    # detection path via occlusion_completion=True).
    trapz = getattr(np, "trapezoid", None) or np.trapz
    u = np.linspace(-1.0, 1.0, 4001)
    f = 2.0 * np.sqrt(np.clip(1.0 - u * u, 0.0, None))
    ss = np.linspace(-0.98, 0.92, 96)
    ratio, shift, sqrt_lv = [], [], []
    for s in ss:
        m = u >= s
        a = trapz(f[m], u[m])
        mu = trapz(u[m] * f[m], u[m]) / a
        lu = trapz((u[m] - mu) ** 2 * f[m], u[m]) / a
        lv = trapz((1.0 - u[m] ** 2) / 3.0 * f[m], u[m]) / a
        ratio.append(np.sqrt(lv / lu))
        shift.append(mu)
        sqrt_lv.append(np.sqrt(lv))
    x = np.log(np.asarray(ratio))
    # PYTHON floats on purpose: this is lru_cached, and caching jnp arrays
    # built during a jit trace would leak tracers into later traces.
    return (tuple(float(c) for c in np.polyfit(x, shift, 7)),
            tuple(float(c) for c in np.polyfit(x, sqrt_lv, 7)))


def _horner(coeffs, x):
    acc = jnp.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        acc = acc * x + c
    return acc


def complete_occluded(fin: Finalized, min_ratio: float, max_ratio: float,
                      min_skew: float):
    """Recover center + diameter of partially occluded markers.

    A marker half-hidden behind an occluder (the probe, README.md:103-121)
    is a disk censored by a roughly straight edge. Its photometric moments
    betray it: the axis ratio exceeds 1 along the cut normal AND the
    intensity distribution is skewed toward the visible side — an ordinary
    elongated ellipse has ratio without skew, so both gates together are
    the occlusion signature. Inverting the censored-disk tables
    (:func:`_occlusion_tables`) on the measured ratio gives the censoring
    depth; from it the true center (measured centroid shifted back along
    the minor axis) and true diameter (from the along-chord spread, which
    the cut leaves least disturbed).

    Returns ``(center, axes, occluded)`` with corrections applied only
    where the signature holds (``occluded`` False elsewhere — values there
    are the uncorrected inputs). The reference drops such markers entirely
    (``3d_reconstruction.py:309-311`` continue-on-failure + the
    ``max_axis_ratio`` gate that replaced it); this keeps them tracked at
    lower confidence.
    """
    c_shift, c_sqlv = _occlusion_polys()
    major = fin.photo_axes[..., 0]
    minor = jnp.maximum(fin.photo_axes[..., 1], 1e-6)
    ratio = major / minor
    occluded = ((ratio >= min_ratio) & (ratio <= max_ratio)
                & (fin.skew >= min_skew))

    # Invert the censored-disk model via the log-ratio polynomials (see
    # _occlusion_polys for why not jnp.interp).
    x = jnp.log(jnp.clip(ratio, 1.003, 8.43))
    # lam_v in axis units: major = 4 sqrt(lam_v) * scale.
    sqrt_lv_meas = major / 4.0
    r_est = sqrt_lv_meas / _horner(c_sqlv, x)
    # The center shift acts on photo_center, which is in RAW pixels, while
    # r_est carries the axis_scale calibration factor baked into photo_axes
    # — divide it out so the displacement is in pixel units (d_est below
    # keeps the scaled units to stay commensurate with photo_axes).
    r_px = r_est / jnp.maximum(fin.axis_scale, 1e-6)
    shift = _horner(c_shift, x) * r_px
    center = fin.photo_center - fin.minor_dir * shift[..., None]
    d_est = 2.0 * r_est
    axes = jnp.stack([d_est, d_est], -1)
    return (jnp.where(occluded[..., None], center, fin.photo_center),
            jnp.where(occluded[..., None], axes, fin.photo_axes),
            occluded)
