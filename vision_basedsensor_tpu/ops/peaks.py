"""Fixed-shape local-maximum peak extraction with distance suppression.

Replaces the reference's ``maximum_filter``/``minimum_filter`` +
``ndimage.label`` + ``center_of_mass`` pipeline (``marker_detection.py:166-183``)
— whose connected-component labeling is data-dependent and shape-unstable —
with: window local-max test on the smooth NCC field, ``top_k`` extraction
into a fixed candidate budget, and an O(K^2) greedy distance suppression to
collapse plateau ties. Sub-pixel refinement happens downstream on mask
centroids (ops/patches.py), mirroring the reference's mask center-of-mass.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from vision_basedsensor_tpu.core.imaging import max_filter


class Peaks(NamedTuple):
    xy: jnp.ndarray     # (..., K, 2) integer pixel coords (x, y) as float32
    score: jnp.ndarray  # (..., K)
    valid: jnp.ndarray  # (..., K) bool


def _suppress(xy: jnp.ndarray, score: jnp.ndarray, valid: jnp.ndarray,
              min_distance: float) -> jnp.ndarray:
    """Drop peaks within ``min_distance`` of a stronger (earlier-ranked) peak."""
    d2 = jnp.sum((xy[:, None, :] - xy[None, :, :]) ** 2, axis=-1)
    k = score.shape[0]
    rank = jnp.arange(k)
    # top_k output is sorted desc, ties broken by index, so earlier == stronger.
    stronger = rank[None, :] < rank[:, None]
    near = d2 < min_distance**2
    killed = jnp.any(stronger & near & valid[None, :], axis=1)
    return valid & ~killed


def select_peaks_from_cells(cmax: jnp.ndarray, cflat: jnp.ndarray, width: int,
                            max_peaks: int, min_distance: float) -> Peaks:
    """Candidate selection from per-cell reductions: ``top_k`` over the cell
    maxima ``cmax`` ``(..., HC, WC)`` + their row-major flat pixel indices
    ``cflat`` (``y * width + x``), then distance suppression. The tail of
    :func:`find_peaks`."""
    batch = cmax.shape[:-2]
    n = cmax.shape[-2] * cmax.shape[-1]
    vals, cidx = jax.lax.top_k(cmax.reshape(batch + (n,)), max_peaks)
    flat = jnp.take_along_axis(cflat.reshape(batch + (n,)), cidx, axis=-1)
    ys = (flat // width).astype(jnp.float32)
    xs = (flat % width).astype(jnp.float32)
    xy = jnp.stack([xs, ys], axis=-1)
    valid = jnp.isfinite(vals)

    sup = _suppress
    for _ in range(cmax.ndim - 2):
        sup = jax.vmap(sup, in_axes=(0, 0, 0, None))
    valid = sup(xy, vals, valid, min_distance)
    return Peaks(xy=xy, score=jnp.where(valid, vals, 0.0), valid=valid)


def find_peaks(score: jnp.ndarray, threshold: float, window: int,
               max_peaks: int, min_distance: float, cell: int = 8) -> Peaks:
    """Extract up to ``max_peaks`` local maxima of ``score`` ``(..., H, W)``.

    A pixel is a candidate when it equals the ``window``-sized local maximum
    and exceeds ``threshold``; candidates are ranked by score and deduplicated
    within ``min_distance`` pixels (plateaus of the thresholded NCC field
    otherwise produce several adjacent candidates where the reference's
    labeling produced one component).

    ``top_k`` over the raw H*W pixels is sort-bound; instead each
    ``cell x cell`` tile is reduced to its best candidate first (max+argmax)
    and ``top_k`` runs over the ~H*W/cell^2 tile maxima. Peaks
    closer than ``cell`` to each other collapse to one candidate per tile —
    safe here because real markers are farther apart than any sensible cell
    (min marker spacing ~20 px vs cell 8).
    """
    h, w = score.shape[-2:]
    local_max = max_filter(score, window)
    is_peak = (score >= local_max) & (score > threshold)
    sp = jnp.where(is_peak, score, -jnp.inf)

    hc = -(-h // cell)
    wc = -(-w // cell)
    pad = [(0, 0)] * (score.ndim - 2) + [(0, hc * cell - h), (0, wc * cell - w)]
    sp = jnp.pad(sp, pad, constant_values=-jnp.inf)
    batch = sp.shape[:-2]
    tiles = sp.reshape(batch + (hc, cell, wc, cell))
    tiles = jnp.moveaxis(tiles, -3, -2).reshape(batch + (hc, wc, cell * cell))
    cmax = jnp.max(tiles, axis=-1)
    coff = jnp.argmax(tiles, axis=-1)

    # Row-major flat pixel index of each cell's winner (width = unpadded w:
    # padded columns hold -inf and can never win a finite cell).
    cyg = jax.lax.broadcasted_iota(jnp.int32, cmax.shape, cmax.ndim - 2)
    cxg = jax.lax.broadcasted_iota(jnp.int32, cmax.shape, cmax.ndim - 1)
    cflat = ((cyg * cell + coff // cell) * w + (cxg * cell + coff % cell))
    return select_peaks_from_cells(cmax, cflat, w, max_peaks, min_distance)
