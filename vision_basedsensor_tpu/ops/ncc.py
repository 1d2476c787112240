"""Normalized cross-correlation against a Gaussian template, fully separable.

The reference computes NCC with three full-frame FFT convolutions per frame
(``marker_detection.py:145-164``) — the dominant cost of its hot loop
(SURVEY.md §3.2). The same quantity decomposes exactly into six 1-D
separable convolutions, because:

* the numerator ``corr(image0, template - mean(template))`` expands to
  ``corr(image, g) - mean(g) * boxsum(image)`` (the template has unit sum, so
  ``mean(g) = 1/n``), and the global image-mean subtraction the reference
  performs cancels exactly (the zero-mean template annihilates constants);
* the denominator's local variance is ``boxsum(image^2) - boxsum(image)^2/n``;
* Gaussian and box kernels are both rank-1 separable.

This keeps every op a dense matmul or elementwise pass, with zero-padded
'same' borders matching ``scipy.signal.fftconvolve(mode='same')``; for binary
inputs (the detector's mask) ``box(m^2)`` is closed-form and only four
filter passes remain.
"""
from __future__ import annotations

import jax.numpy as jnp

import functools

import numpy as np

from vision_basedsensor_tpu.core.imaging import conv_same_zero, gaussian_taps


@functools.lru_cache(maxsize=16)
def _box_count(h: int, w: int, ksize: int) -> np.ndarray:
    """In-image pixel count of each zero-padded 'same' box window."""
    lo, hi = (ksize - 1) // 2, ksize // 2

    def axis_count(n):
        i = np.arange(n)
        return (np.minimum(i + hi, n - 1) - np.maximum(i - lo, 0) + 1.0)

    return np.outer(axis_count(h), axis_count(w)).astype(np.float32)


def normxcorr_gaussian(image: jnp.ndarray, ksize: int, sigma: float,
                       min_variance: float = 0.5,
                       binary_input: bool = False,
                       compute_dtype=None) -> jnp.ndarray:
    """NCC of ``image`` ``(..., H, W)`` with a unit-sum Gaussian template.

    Matches ``MarkerTracker._normxcorr2(_gkern(ksize, sigma), image)``
    (``marker_detection.py:132,145-164``) up to FFT round-off, for any image
    scaling (NCC is scale-invariant, so the reference's 0/255 mask and a 0/1
    mask give identical scores).
    """
    raw = jnp.asarray(image, jnp.float32)
    # The reference subtracts the global image mean before correlating
    # (:152-153). In the interior this cancels exactly (the zero-mean
    # template annihilates constants), but it changes what the zero-padded
    # borders mean, so it is replicated for bit-level parity there too.
    mu = jnp.mean(raw, axis=(-2, -1), keepdims=True)
    image = raw - mu
    g = gaussian_taps(ksize, sigma)
    n = float(ksize * ksize)
    ones = np.ones(ksize)

    corr_g = conv_same_zero(image, g, g, compute_dtype)
    box1 = conv_same_zero(image, ones, ones, compute_dtype)
    if binary_input:
        # For 0/1 inputs raw^2 == raw, so with m = raw - mu:
        #   box(m^2) = (1 - 2 mu) box(raw) + mu^2 * count
        #   box(raw) = box(m) + mu * count
        # where count is the (input-independent) number of in-image pixels
        # each zero-padded box window covers — a closed-form constant, so
        # this saves two of the six filter passes.
        count = jnp.asarray(_box_count(image.shape[-2], image.shape[-1], ksize),
                            image.dtype)
        box_raw = box1 + mu * count
        box2 = (1.0 - 2.0 * mu) * box_raw + mu * mu * count
    else:
        box2 = conv_same_zero(image * image, ones, ones, compute_dtype)

    num = corr_g - box1 / n
    var_n = jnp.maximum(box2 - box1 * box1 / n, 0.0)

    g2d = np.outer(g, g)
    t0_energy = float(np.sum((g2d - np.mean(g2d)) ** 2))

    den = jnp.sqrt(var_n * t0_energy)
    # The reference zeroes non-finite outputs (:163). Flat windows must score
    # 0, and float32 conv round-off can leave var_n ~ 1e-4 on constant
    # regions, which would blow up the ratio; for 0/1-valued images the
    # smallest true nonzero variance is 1 - 1/n, so the default floor of 0.5
    # is exact for binary masks. Pass a smaller ``min_variance`` for
    # continuous-valued images.
    return jnp.where(var_n >= min_variance, num / jnp.maximum(den, 1e-12), 0.0)
