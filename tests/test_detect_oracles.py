"""The detector's plain-XLA stages against independent numpy/scipy oracles.

* ``window_sums_xla`` (the 28 per-peak moment sums) vs a float64 numpy loop
  over each window's pixels, at interior, border and right-border peaks,
  the high-res profile, short frames, odd K and heights that are not a
  multiple of 8;
* ``min_filter`` / ``max_filter`` / ``morph_open`` vs ``scipy.ndimage`` and
  ``find_peaks`` vs a numpy transcription of its contract (local max over a
  window, best pixel per 8x8 cell with row-major ties, ranked top-K,
  suppression within ``min_distance`` of any stronger candidate), at
  240x384 and 480x640 and on plateau ties;
* ``detect_markers`` end to end at frame heights on either side of the
  480-row profile switch (472, 488, 968 rows) vs the synthetic ground truth.
"""
import numpy as np
import pytest
import scipy.ndimage as ndi

import jax.numpy as jnp

from vision_basedsensor_tpu.config import DetectConfig
from vision_basedsensor_tpu.core.camera import project_points
from vision_basedsensor_tpu.core.imaging import (max_filter, min_filter,
                                                 morph_open, to_grayscale)
from vision_basedsensor_tpu.detect import detect_markers
from vision_basedsensor_tpu.ops.dog import dog_area_mask
from vision_basedsensor_tpu.ops.moments import (NUM_SUMS, cut_geometry,
                                                window_sums_xla)
from vision_basedsensor_tpu.ops.ncc import normxcorr_gaussian
from vision_basedsensor_tpu.ops.peaks import Peaks, find_peaks
from vision_basedsensor_tpu.synth import default_scene, render_frames

CFG = DetectConfig()


# --------------------------------------------------------------------------
# Oracles
# --------------------------------------------------------------------------

def window_sums_oracle(band, area, gray, xy, valid, profile):
    """The 28 sums of ops/moments.py's layout, pixel by pixel in float64.

    Window: ``patch_size`` square around the rounded peak, clamped inside
    the frame. Cut: radial cutoff plus the halfplanes bisecting the peak
    and its three nearest valid neighbours."""
    band, area, gray = (np.asarray(a, np.float64) for a in (band, area, gray))
    xy = np.asarray(xy, np.float64)
    valid = np.asarray(valid)
    h, w = gray.shape
    p, half = profile.patch_size, profile.patch_size // 2
    out = np.zeros((len(xy), NUM_SUMS))
    for k, (px, py) in enumerate(xy):
        others = [j for j in range(len(xy)) if j != k and valid[j]]
        d2 = [((xy[j] - xy[k]) ** 2).sum() for j in others]
        nbrs = [others[i] for i in np.argsort(d2, kind="stable")[:3]]
        x0 = int(np.clip(np.round(px) - half, 0, w - p))
        y0 = int(np.clip(np.round(py) - half, 0, h - p))
        gy, gx = np.mgrid[y0:y0 + p, x0:x0 + p].astype(np.float64)
        dx, dy = gx - px, gy - py
        cut = dx * dx + dy * dy <= profile.radial_cutoff_px ** 2
        for j in nbrs:
            ex, ey = xy[j] - xy[k]
            cut &= dx * ex + dy * ey <= 0.5 * (ex * ex + ey * ey) + 1e-3
        c = cut.astype(np.float64)
        b = band[y0:y0 + p, x0:x0 + p] * c
        a = area[y0:y0 + p, x0:x0 + p] * c
        g = gray[y0:y0 + p, x0:x0 + p]
        lo = g[cut].min() if cut.any() else np.inf
        hi = g[cut].max() if cut.any() else -np.inf
        wt = np.clip((hi - g) / max(hi - lo, 1e-3), 0.0, 1.0)
        f = profile.soft_floor
        if f > 0:
            wt = np.clip((wt - f) / (1.0 - 2.0 * f), 0.0, 1.0)
        wt = wt * c
        wh = (wt >= 0.5).astype(np.float64)

        def m(v):
            return [v.sum(), (v * dx).sum(), (v * dy).sum()]

        def m2(v):
            return [(v * dx * dx).sum(), (v * dy * dy).sum(),
                    (v * dx * dy).sum()]

        out[k] = (m(b) + m(a) + m2(a) + m(wt) + m2(wt) + m(wh) + m2(wh)
                  + [lo, hi, c.sum()]
                  + [(wt * dx ** 3).sum(), (wt * dx * dx * dy).sum(),
                     (wt * dx * dy * dy).sum(), (wt * dy ** 3).sum()])
    return out


def find_peaks_oracle(score, threshold, window, max_peaks, min_distance,
                      cell=8):
    score = np.asarray(score, np.float64)
    h, w = score.shape
    lm = ndi.maximum_filter(score, size=window, mode="constant",
                            cval=-np.inf)
    sp = np.where((score >= lm) & (score > threshold), score, -np.inf)
    cells = []
    for cy in range(0, h, cell):
        for cx in range(0, w, cell):
            tile = sp[cy:cy + cell, cx:cx + cell]
            iy, ix = np.unravel_index(np.argmax(tile), tile.shape)
            cells.append((tile[iy, ix], cx + ix, cy + iy))
    vals = np.array([c[0] for c in cells])
    order = np.argsort(-vals, kind="stable")[:max_peaks]
    xy = np.array([[cells[i][1], cells[i][2]] for i in order], np.float64)
    v = vals[order]
    valid = np.isfinite(v)
    d2 = ((xy[:, None] - xy[None]) ** 2).sum(-1)
    killed = np.array([any(valid[j] and d2[k, j] < min_distance ** 2
                           for j in range(k)) for k in range(len(v))])
    return xy, v, valid & ~killed


# --------------------------------------------------------------------------
# Fixtures
# --------------------------------------------------------------------------

def _fields(gray, profile):
    area = dog_area_mask(gray, profile, CFG.dog_offset)
    ncc = normxcorr_gaussian(area.astype(jnp.float32), profile.template_size,
                             profile.template_sigma, binary_input=True)
    m = (ncc > CFG.ncc_threshold).astype(jnp.float32)
    band = m * (min_filter(m, profile.band_window) < 0.5)
    area_open = morph_open(area.astype(jnp.float32), CFG.open_ksize)
    return ncc, band, area_open


@pytest.fixture(scope="module")
def scene_fields():
    prof = CFG.low_res
    frame = render_frames(default_scene(240, 384),
                          jnp.zeros((1, 65, 3), jnp.float32))[0]
    gray = to_grayscale(frame)
    ncc, band, area_open = _fields(gray, prof)
    peaks = find_peaks(ncc, CFG.ncc_threshold, prof.peak_window,
                       CFG.max_candidates, float(prof.peak_window))
    return gray, band, area_open, peaks


def _random_fields(h, w, seed):
    rng = np.random.default_rng(seed)
    gray = jnp.asarray(rng.integers(0, 256, (h, w)), jnp.float32)
    band = jnp.asarray(rng.random((h, w)) > 0.7, jnp.float32)
    area = jnp.asarray(rng.random((h, w)) > 0.6, jnp.float32)
    return gray, band, area


def _peaks(xy, k):
    xy = np.asarray(xy, np.float32)
    n = len(xy)
    full = np.full((k, 2), 60.0, np.float32)
    full[:n] = xy
    return Peaks(xy=jnp.asarray(full), score=jnp.ones(k),
                 valid=jnp.arange(k) < n)


def _window_case(case, scene_fields):
    """(gray, band, area, peaks, profile) for each window-sums case. Peak
    offsets are dyadic so float32 and float64 place them identically."""
    k = CFG.max_candidates
    if case == "interior":
        gray, band, area, peaks = scene_fields
        return gray, band, area, peaks, CFG.low_res
    if case == "border":
        gray, band, area, _ = scene_fields
        h, w = gray.shape
        return gray, band, area, _peaks(
            [[1.25, 1.75], [w - 2.125, 1.25], [1.5, h - 1.75],
             [w - 1.5, h - 2.25], [w / 2, 0.5], [0.5, h / 2],
             [w - 1.0, h / 2], [w / 2, h - 1.0]], k), CFG.low_res
    if case == "right_border":
        gray, band, area = _random_fields(240, 384, 3)
        h, w = gray.shape
        return gray, band, area, _peaks(
            [[w - 5, h / 2], [w - 1.25, h / 2], [w - 17.5, 40.0],
             [w - 5, 1.5], [w - 5, h - 2.0], [w / 2, h / 2]], k), CFG.low_res
    if case == "high_res":
        gray, band, area = _random_fields(240, 384, 11)
        h, w = gray.shape
        rng = np.random.default_rng(11)
        xy = np.round(rng.uniform([2, 2], [w - 2, h - 2], (24, 2)) * 8) / 8
        xy[:8] = [[w - 1.5, h / 2], [1.5, h / 2], [w / 2, 1.5],
                  [w / 2, h - 1.5], [w - 2, h - 2], [2, 2], [w - 33, h / 2],
                  [33, h / 2]]
        return gray, band, area, _peaks(xy, k), CFG.high_res
    if case == "short_frame":
        gray, band, area = _random_fields(44, 256, 5)
        return gray, band, area, _peaks(
            [[20.0, 10.0], [100.5, 30.25], [250.0, 43.0], [128.0, 22.0]],
            k), CFG.low_res
    if case == "odd_k":
        gray, band, area, peaks = scene_fields
        return gray, band, area, Peaks(*(v[:95] for v in peaks)), CFG.low_res
    if case == "height_236":
        gray, band, area = _random_fields(236, 384, 7)
        h, w = gray.shape
        return gray, band, area, _peaks(
            [[100.0, h - 1.5], [w - 3.0, h - 3.0], [200.0, 118.0],
             [50.0, h - 17.0]], k), CFG.low_res
    raise ValueError(case)


@pytest.mark.parametrize("case", ["interior", "border", "right_border",
                                  "high_res", "short_frame", "odd_k",
                                  "height_236"])
def test_window_sums_match_numpy_loop(case, scene_fields):
    gray, band, area, peaks, prof = _window_case(case, scene_fields)
    got = np.asarray(window_sums_xla(band, area, gray, peaks,
                                     cut_geometry(peaks), prof))
    v = np.asarray(peaks.valid)
    assert v.sum() >= 4
    want = window_sums_oracle(band, area, gray, peaks.xy, v, prof)[v]
    got = got[v]
    fin = np.isfinite(want)
    np.testing.assert_array_equal(fin, np.isfinite(got))
    np.testing.assert_array_equal(got[:, 23], want[:, 23])   # gated pixels
    # float32 sums of up to 64x64 products: the third moments reach ~1e6,
    # so the tolerance scales with each column's magnitude.
    scale = np.abs(np.where(fin, want, 0.0)).max(0, keepdims=True)
    np.testing.assert_allclose(np.where(fin, got, 0.0),
                               np.where(fin, want, 0.0),
                               rtol=1e-5, atol=1e-5 * scale.max() + 1e-3)
    for col in range(NUM_SUMS):
        c = fin[:, col]
        np.testing.assert_allclose(got[c, col], want[c, col], rtol=1e-4,
                                   atol=2e-5 * scale[0, col] + 1e-3,
                                   err_msg=f"sum {col}")


# --------------------------------------------------------------------------
# Field ops
# --------------------------------------------------------------------------

def _rendered(h, w):
    frame = render_frames(default_scene(h, w),
                          jnp.zeros((1, 65, 3), jnp.float32)
                          .at[0, :, 2].add(-0.6))[0]
    gray = to_grayscale(frame)
    area = dog_area_mask(gray, CFG.low_res, CFG.dog_offset)
    ncc = normxcorr_gaussian(area.astype(jnp.float32),
                             CFG.low_res.template_size,
                             CFG.low_res.template_sigma, binary_input=True)
    return np.asarray(area, np.float32), np.asarray(ncc, np.float32)


SHAPES = [(240, 384), (480, 640)]


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("k", [8, 14])
def test_min_filter_matches_scipy(hw, k):
    _, ncc = _rendered(*hw)
    mask = (ncc > CFG.ncc_threshold).astype(np.float32)
    want = ndi.minimum_filter(mask, size=k, mode="constant", cval=np.inf)
    np.testing.assert_array_equal(np.asarray(min_filter(jnp.asarray(mask),
                                                        k)), want)


@pytest.mark.parametrize("hw", SHAPES)
def test_max_filter_matches_scipy(hw):
    _, ncc = _rendered(*hw)
    want = ndi.maximum_filter(ncc, size=9, mode="constant", cval=-np.inf)
    np.testing.assert_array_equal(np.asarray(max_filter(jnp.asarray(ncc), 9)),
                                  want)


@pytest.mark.parametrize("hw", SHAPES)
def test_morph_open_matches_scipy(hw):
    area, _ = _rendered(*hw)
    k = CFG.open_ksize
    want = ndi.maximum_filter(
        ndi.minimum_filter(area, size=k, mode="constant", cval=np.inf),
        size=k, mode="constant", cval=-np.inf)
    got = np.asarray(morph_open(jnp.asarray(area), k))
    np.testing.assert_array_equal(got, want)
    # A binary opening with a square element: what cv2.morphologyEx did.
    inner = (slice(k, -k), slice(k, -k))
    np.testing.assert_array_equal(
        got[inner] > 0.5,
        ndi.binary_opening(area > 0.5, np.ones((k, k)))[inner])


def _score_case(case):
    if case in ("240x384", "480x640"):
        return _rendered(*map(int, case.split("x")))[1]
    rng = np.random.default_rng(7)
    # Heavy quantization: exact plateaus inside and across cells.
    return (np.round(rng.random((240, 384)) * 8.0) / 8.0).astype(np.float32)


@pytest.mark.parametrize("case", ["240x384", "480x640", "plateau_ties"])
def test_find_peaks_matches_oracle(case):
    score = _score_case(case)
    prof = CFG.low_res
    got = find_peaks(jnp.asarray(score), CFG.ncc_threshold, prof.peak_window,
                     CFG.max_candidates, float(prof.peak_window))
    xy, val, valid = find_peaks_oracle(score, CFG.ncc_threshold,
                                       prof.peak_window, CFG.max_candidates,
                                       float(prof.peak_window))
    gv = np.asarray(got.valid)
    np.testing.assert_array_equal(gv, valid)
    np.testing.assert_array_equal(np.asarray(got.xy)[gv], xy[valid])
    np.testing.assert_allclose(np.asarray(got.score)[gv], val[valid],
                               rtol=1e-6)
    if case != "plateau_ties":
        assert valid.sum() >= 60


def test_find_peaks_high_res_profile_matches_oracle():
    frame = render_frames(default_scene(544, 768),
                          jnp.zeros((1, 65, 3), jnp.float32))[0]
    prof = CFG.high_res
    area = dog_area_mask(to_grayscale(frame), prof, CFG.dog_offset)
    score = np.asarray(normxcorr_gaussian(
        area.astype(jnp.float32), prof.template_size, prof.template_sigma,
        binary_input=True), np.float32)
    got = find_peaks(jnp.asarray(score), CFG.ncc_threshold, prof.peak_window,
                     CFG.max_candidates, float(prof.peak_window))
    xy, _, valid = find_peaks_oracle(score, CFG.ncc_threshold,
                                     prof.peak_window, CFG.max_candidates,
                                     float(prof.peak_window))
    np.testing.assert_array_equal(np.asarray(got.valid), valid)
    np.testing.assert_array_equal(np.asarray(got.xy)[valid], xy[valid])


# --------------------------------------------------------------------------
# End to end around the profile switch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(472, 640), (488, 640), (968, 1280)])
def test_detect_end_to_end_vs_ground_truth(h, w):
    """472 rows: the low-res profile, 65/65 within 0.1 px. 968 rows: the
    high-res profile on a scene scaled to it, 65/65; its clipped outer-ring
    markers keep the worst centroid within 1.5 px (chip_smoke.py). 488
    rows: the reference's switch picks the high-res constants (whose
    windows expect ~960p-scale markers, so they are checked to be chosen,
    not to track a 480p-scale scene); the low-res constants at 488 rows
    track it like at 472."""
    import dataclasses

    scene = default_scene(h, w)
    frames = render_frames(scene, jnp.zeros((1, 65, 3), jnp.float32))
    cfg = CFG
    if h == 488:
        high = detect_markers(frames, CFG, profile=CFG.high_res)
        np.testing.assert_array_equal(
            np.asarray(detect_markers(frames, CFG).xy),
            np.asarray(high.xy))
        cfg = dataclasses.replace(CFG, low_res_max_rows=488)
    det = detect_markers(frames, cfg)
    truth = np.asarray(project_points(scene.cam, scene.marker_world))
    valid = np.asarray(det.valid)[0]
    xy = np.asarray(det.xy)[0][valid]
    err = np.array([np.linalg.norm(truth - p, axis=1).min() for p in xy])
    assert valid.sum() == 65
    assert len(set(np.argmin(np.linalg.norm(truth[:, None] - xy[None], axis=2),
                             axis=0))) == 65
    if h <= cfg.low_res_max_rows:
        assert err.max() < 0.1
    else:
        assert err.max() < 1.5 and np.median(err) < 0.1
