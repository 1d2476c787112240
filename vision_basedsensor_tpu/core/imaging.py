"""Imaging primitives: grayscale, separable Gaussian/box filters, morphology.

Fixed-shape replacements for the reference's OpenCV/SciPy image ops
(``cv2.cvtColor``/``cv2.GaussianBlur`` at ``marker_detection.py:114-124``,
``scipy.ndimage`` max/min filters at ``:171-173``, ``cv2.morphologyEx`` at
``:194-195``). Everything is batched over a leading frame axis and uses only
fixed-shape ops.

Separable filters are evaluated as dense banded matmuls with border
handling folded into the band matrix: ~20x more FLOPs than the taps, in
exchange for one large matrix product per axis. Whether that or a direct
separable convolution is faster on a GPU, per frame size, is an open
measurement. Morphology lowers to ``lax.reduce_window``.

Convention: images are ``(..., H, W)`` float32 (values 0..255 for 8-bit
sources).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# BT.601 luma weights used by cv2.COLOR_BGR2GRAY.
_BGR_WEIGHTS = (0.114, 0.587, 0.299)


def to_grayscale(frames: jnp.ndarray, channel_order: str = "bgr",
                 quantize: bool = True) -> jnp.ndarray:
    """``(..., H, W, 3)`` color (or ``(..., H, W)`` gray) -> float32 gray.

    Matches ``cv2.cvtColor(. , COLOR_BGR2GRAY)`` on uint8 inputs: BT.601
    weights, rounded to the nearest integer when ``quantize`` is set.
    """
    frames = jnp.asarray(frames)
    if frames.ndim >= 1 and frames.shape[-1] == 3:
        w = _BGR_WEIGHTS if channel_order == "bgr" else _BGR_WEIGHTS[::-1]
        w = jnp.asarray(w, jnp.float32)
        # HIGHEST: the weighted sum is rounded to integer gray levels next,
        # and a TF32 product would move values across the rounding point.
        gray = jnp.tensordot(frames.astype(jnp.float32), w, axes=[[-1], [0]],
                             precision=jax.lax.Precision.HIGHEST)
    else:
        gray = frames.astype(jnp.float32)
    if quantize:
        gray = jnp.floor(gray + 0.5)
    return gray


def gaussian_taps(ksize: int, sigma: float) -> np.ndarray:
    """Normalized 1D Gaussian taps (host numpy), identical to
    ``cv2.getGaussianKernel``."""
    ax = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-0.5 * (ax / sigma) ** 2)
    return k / k.sum()


def gaussian_kernel_1d(ksize: int, sigma: float, dtype=jnp.float32) -> jnp.ndarray:
    """Normalized 1D Gaussian taps as a device array."""
    return jnp.asarray(gaussian_taps(ksize, sigma), dtype)


def gaussian_kernel_2d(ksize: int, sigma: float, dtype=jnp.float32) -> jnp.ndarray:
    """Normalized 2D Gaussian, identical to ``MarkerTracker._gkern``
    (``marker_detection.py:137-143``)."""
    k = gaussian_kernel_1d(ksize, sigma, dtype)
    k2 = jnp.outer(k, k)
    return k2 / k2.sum()


@functools.lru_cache(maxsize=64)
def _band_matrix(taps: tuple, n: int, mode: str) -> np.ndarray:
    """Dense banded correlation matrix T with ``y[i] = sum_j T[i, j] x[j]``.

    Border handling is folded into the matrix: 'reflect101' adds the
    reflected tap weights onto interior columns (exactly OpenCV's
    BORDER_REFLECT_101), 'zero' clips (fftconvolve 'same').
    """
    k = len(taps)
    lo = (k - 1) // 2  # taps cover offsets [-lo, k-1-lo]
    T = np.zeros((n, n), np.float32)
    for i in range(n):
        for t, w in enumerate(taps):
            j = i - lo + t
            if mode == "reflect101":
                # reflect101: ... x2 x1 | x0 x1 x2 ... xn-1 | xn-2 xn-3 ...
                period = 2 * (n - 1) if n > 1 else 1
                j = abs(j) % period
                if j >= n:
                    j = period - j
            elif not (0 <= j < n):
                continue
            T[i, j] += w
    return T


def _sep_filter(x: jnp.ndarray, taps_h, taps_w, mode: str,
                compute_dtype=None) -> jnp.ndarray:
    """Separable filter along (H, W) as two banded matmuls.

    ``compute_dtype=jnp.bfloat16`` runs the matmuls with bf16 operands and
    f32 accumulation. 8-bit image values are exact in
    bf16; only the band-matrix weights lose ~0.4% relative precision, so
    filtered values land within ~0.2 gray levels of the f32 path.
    """
    h, w = x.shape[-2:]
    acc = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.float32
    dt = acc if compute_dtype is None else compute_dtype
    # The filtered fields are rounded, wrapped modulo 256 and thresholded
    # (ops/dog.py, ops/ncc.py), so the f32 path pins full f32 products: a
    # TF32 matmul keeps ~3 decimal digits and flips threshold pixels. The
    # bf16 path (``compute_dtype``, DetectConfig.fast_filters) opts out.
    prec = jax.lax.Precision.HIGHEST if compute_dtype is None else None
    y = x.astype(dt)
    if taps_h is not None:
        Th = jnp.asarray(_band_matrix(tuple(float(t) for t in taps_h), h, mode), dt)
        y = jnp.einsum("ik,...kw->...iw", Th, y, precision=prec,
                       preferred_element_type=acc).astype(dt)
    if taps_w is not None:
        Tw = jnp.asarray(_band_matrix(tuple(float(t) for t in taps_w), w, mode), dt)
        y = jnp.einsum("...hk,jk->...hj", y, Tw, precision=prec,
                       preferred_element_type=acc)
    return y.astype(acc)


def gaussian_blur(x: jnp.ndarray, ksize: int, sigma: float,
                  quantize: bool = False, compute_dtype=None) -> jnp.ndarray:
    """Separable Gaussian blur with BORDER_REFLECT_101, matching
    ``cv2.GaussianBlur(src, (k, k), sigma)``.

    ``quantize`` rounds to the nearest integer, emulating uint8 output
    quantization of the reference's 8-bit pipeline.
    """
    k = gaussian_taps(ksize, sigma)
    y = _sep_filter(x, k, k, "reflect101", compute_dtype)
    if quantize:
        y = jnp.floor(y + 0.5)
    return y


def box_sum(x: jnp.ndarray, ksize: int) -> jnp.ndarray:
    """Unnormalized ksize x ksize box sum with zero padding (fftconvolve-style
    'same' borders), used by the NCC decomposition."""
    ones = np.ones(ksize)
    return _sep_filter(x, ones, ones, "zero")


def conv_same_zero(x: jnp.ndarray, kh, kw, compute_dtype=None) -> jnp.ndarray:
    """Separable 'same' convolution with zero padding along (H, W)."""
    return _sep_filter(x, np.asarray(kh), np.asarray(kw), "zero", compute_dtype)


def _reduce_window_2d(x: jnp.ndarray, ksize: int, init, op) -> jnp.ndarray:
    dims = (1,) * (x.ndim - 2) + (ksize, ksize)
    # Window offsets [-k//2, k//2-1] for even k, matching scipy.ndimage's
    # footprint placement (the reference uses even neighborhoods 8/14 at
    # marker_detection.py:170).
    pad = [(0, 0)] * (x.ndim - 2) + [(ksize // 2, (ksize - 1) // 2)] * 2
    return jax.lax.reduce_window(x, init, op, dims, (1,) * x.ndim, pad)


def max_filter(x: jnp.ndarray, ksize: int) -> jnp.ndarray:
    """Sliding-window maximum (scipy ``maximum_filter`` analog; grey dilation)."""
    return _reduce_window_2d(x, ksize, -jnp.inf if jnp.issubdtype(x.dtype, jnp.floating) else jnp.iinfo(x.dtype).min, jax.lax.max)


def min_filter(x: jnp.ndarray, ksize: int) -> jnp.ndarray:
    """Sliding-window minimum (scipy ``minimum_filter`` analog; grey erosion)."""
    return _reduce_window_2d(x, ksize, jnp.inf if jnp.issubdtype(x.dtype, jnp.floating) else jnp.iinfo(x.dtype).max, jax.lax.min)


def morph_open(mask: jnp.ndarray, ksize: int) -> jnp.ndarray:
    """Binary morphological opening (erode then dilate) with a square
    structuring element — ``cv2.morphologyEx(MORPH_OPEN)`` analog
    (``marker_detection.py:194-195``). ``mask`` is float 0/1."""
    return max_filter(min_filter(mask, ksize), ksize)


def frame_hw(frames) -> tuple[int, int]:
    """(H, W) of a frame array, channel-last aware (trailing dim <= 4)."""
    if frames.ndim >= 3 and frames.shape[-1] <= 4:
        return frames.shape[-3], frames.shape[-2]
    return frames.shape[-2], frames.shape[-1]


def crop_frames(frames: jnp.ndarray, hw: tuple[int, int] | None = None,
                crop_ratios: tuple[float, float, float, float] = (0, 0, 0, 0)
                ) -> jnp.ndarray:
    """Ratio crop (left, right, top, bottom), matching
    ``marker_detection.py:81-85`` integer arithmetic. Handles both
    ``(..., H, W)`` and channel-last ``(..., H, W, C<=4)`` layouts; crop
    bounds derive from static shapes so results stay fixed-shape under jit."""
    hw = frame_hw(frames) if hw is None else hw
    h, w = hw
    left = int(w * crop_ratios[0])
    right = w - int(w * crop_ratios[1])
    top = int(h * crop_ratios[2])
    bottom = h - int(h * crop_ratios[3])
    if frames.ndim >= 3 and frames.shape[-1] <= 4:
        return frames[..., top:bottom, left:right, :]
    return frames[..., top:bottom, left:right]
