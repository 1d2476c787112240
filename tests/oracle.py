"""Reference-semantics oracle for parity tests.

Implements the *documented behavior* of the reference detector (SURVEY.md §2,
C4/C5: uint8 DoG band-pass -> inRange -> FFT NCC vs Gaussian template ->
local-maxima labeling -> mask center-of-mass) directly on top of
OpenCV/SciPy, so the JAX implementation can be compared against the same
numeric pipeline the reference runs. Test fixture only — not part of the
framework.
"""
from __future__ import annotations

import numpy as np

import cv2
from scipy import ndimage
from scipy.signal import fftconvolve


def gaussian_template(size: int, sigma: float) -> np.ndarray:
    ax = np.linspace(-(size - 1) / 2.0, (size - 1) / 2.0, size)
    xx, yy = np.meshgrid(ax, ax)
    k = np.exp(-0.5 * (xx**2 + yy**2) / sigma**2)
    return k / k.sum()


def normxcorr(template: np.ndarray, image: np.ndarray) -> np.ndarray:
    t = template - template.mean()
    img = image - image.mean()
    num = fftconvolve(img, t[::-1, ::-1], mode="same")
    ones = np.ones(t.shape)
    box = fftconvolve(img, ones, mode="same")
    var_n = fftconvolve(img * img, ones, mode="same") - box**2 / t.size
    var_n[var_n < 0] = 0
    with np.errstate(divide="ignore", invalid="ignore"):
        out = num / np.sqrt(var_n * np.sum(t * t))
    out[~np.isfinite(out)] = 0
    return out


def area_mask_uint8(gray_u8: np.ndarray, low_res: bool = True) -> np.ndarray:
    """uint8 DoG + inRange with native wraparound."""
    if low_res:
        small = cv2.GaussianBlur(gray_u8, (21, 21), 4.56)
        large = cv2.GaussianBlur(gray_u8, (35, 35), 11.4)
        lo, hi = 35, 180
    else:
        small = cv2.GaussianBlur(gray_u8, (39, 39), 8)
        large = cv2.GaussianBlur(gray_u8, (101, 101), 20)
        lo, hi = 20, 200
    dog = large - small + np.uint8(15)  # wraps mod 256 like the reference
    return cv2.inRange(dog, np.array(lo), np.array(hi))


def detect_markers_full(gray_u8: np.ndarray, low_res: bool = True):
    """Detector + ellipse stage (reference ``_marker_center``,
    marker_detection.py:166-249): CoM centroids of the NCC mask, then
    contours of the opened area mask fit with cv2.fitEllipse, each matched to
    the nearest interior centroid within (minor/10)^2 px^2.

    Returns list of (cx, cy, major, minor, angle) — center is the matched CoM
    centroid, axes/angle from the contour ellipse, like the rows the
    reference records (:380-391).
    """
    centers, ncc, area = detect_centers(gray_u8, low_res)
    opened = cv2.morphologyEx(area, cv2.MORPH_OPEN, np.ones((5, 5), np.uint8))
    contours, _ = cv2.findContours(opened, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_NONE)
    out = []
    for cnt in contours:
        if len(cnt) < 5:
            continue
        (ex, ey), (w, h), ang = cv2.fitEllipse(cnt)
        major, minor = max(w, h), min(w, h)
        if minor < 5:  # marker_detection.py:219
            continue
        if len(centers) == 0:
            continue
        d2 = ((centers - [ex, ey]) ** 2).sum(1)
        j = int(d2.argmin())
        if d2[j] < (minor / 10.0) ** 2:  # :225-234
            out.append((centers[j, 0], centers[j, 1], major, minor, ang))
    return out


def assign_ids_intended(markers, n_rings: int = 5):
    """First-frame ID assignment — the reference's *intended* semantics
    (marker_detection.py:275-347 with quirk §2.2-2 fixed): center marker =
    nearest to the centroid of all; KMeans (k=5) on radial distance; rings
    re-indexed by ascending radius; within each ring markers sorted CCW by
    angle with index 0 = the marker nearest angle 0.

    Returns dict (row, col) -> marker tuple; center is (0, 0).
    """
    from sklearn.cluster import KMeans
    pts = np.array([(m[0], m[1]) for m in markers])
    ci = int(((pts - pts.mean(0)) ** 2).sum(1).argmin())
    rel = pts - pts[ci]
    rad = np.hypot(rel[:, 0], rel[:, 1])
    ang = np.degrees(np.arctan2(rel[:, 1], rel[:, 0]))

    others = [i for i in range(len(pts)) if i != ci]
    km = KMeans(n_clusters=n_rings, n_init=10, random_state=0).fit(
        rad[others].reshape(-1, 1))
    order = np.argsort(km.cluster_centers_.ravel())
    ring_of_label = {int(lbl): r + 1 for r, lbl in enumerate(order)}

    ids = {(0, 0): markers[ci]}
    for ring in range(1, n_rings + 1):
        members = [others[k] for k in range(len(others))
                   if ring_of_label[int(km.labels_[k])] == ring]
        if not members:
            continue
        # CCW by angle; index 0 = marker nearest angle 0 (:329-347 intended).
        members.sort(key=lambda i: ang[i])
        zero = min(range(len(members)),
                   key=lambda k: abs((ang[members[k]] + 180) % 360 - 180))
        for k in range(len(members)):
            ids[(ring, k)] = markers[members[(zero + k) % len(members)]]
    return ids


def track_video(frames_u8: np.ndarray, low_res: bool = True,
                gate_px: float = 20.0, n_rings: int = 5):
    """Full intended reference pipeline over a video: detect -> frame-0 IDs
    -> per-frame nearest-neighbor tracking -> CSV-schema rows
    (tracking.py:13-26): (frameno, row, col, Ox, Oy, Cx, Cy, major_axis,
    minor_axis, angle)."""
    from scipy.spatial.distance import cdist
    rows = []
    ref_ids = None
    for t in range(frames_u8.shape[0]):
        markers = detect_markers_full(frames_u8[t], low_res)
        if t == 0:
            ref_ids = assign_ids_intended(markers, n_rings)
        cur = np.array([(m[0], m[1]) for m in markers])
        for (row, col), refm in sorted(ref_ids.items()):
            d = cdist([[refm[0], refm[1]]], cur)[0]  # gate vs frame 0 (:363)
            j = int(d.argmin())
            if d[j] <= gate_px:
                m = markers[j]
                rows.append(dict(frameno=t, row=row, col=col,
                                 Ox=refm[0], Oy=refm[1],
                                 Cx=m[0], Cy=m[1], major_axis=m[2],
                                 minor_axis=m[3], angle=m[4]))
    return rows


def detect_centers(gray_u8: np.ndarray, low_res: bool = True):
    """Full oracle: returns (centers_xy (N,2) float, ncc, area_mask)."""
    area = area_mask_uint8(gray_u8, low_res)
    tmpl = gaussian_template(33 if low_res else 80, 7.4 if low_res else 13)
    ncc = normxcorr(tmpl, area.astype(np.float64))
    mask = (ncc > 0.1).astype(np.uint8)

    nb = 8 if gray_u8.shape[0] <= 480 else 14
    data_max = ndimage.maximum_filter(mask, nb)
    maxima = (mask == data_max)
    spread = (data_max - ndimage.minimum_filter(mask, nb)) > 0
    maxima &= spread

    labeled, n = ndimage.label(maxima)
    if n == 0:
        return np.zeros((0, 2)), ncc, area
    com = ndimage.center_of_mass(mask, labeled, range(1, n + 1))
    centers = np.array(com, dtype=np.float64).reshape(-1, 2)
    return centers[:, ::-1].copy(), ncc, area  # (x, y)
