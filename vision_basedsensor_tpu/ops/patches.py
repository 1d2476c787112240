"""Fixed-size window extraction around peak locations.

Gives downstream moment/centroid math a static ``(K, P, P)`` shape regardless
of how many markers are present — the fixed-shape answer to the reference's
per-contour Python loops (``marker_detection.py:198-249``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def extract_patches(img: jnp.ndarray, centers_xy: jnp.ndarray, patch: int
                    ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Extract ``patch x patch`` windows centered on ``centers_xy``.

    ``img: (H, W)``, ``centers_xy: (K, 2)`` float (x, y). Windows are clamped
    inside the frame. Returns ``(patches (K, P, P), start_xy (K, 2))`` where
    ``start_xy`` is the top-left corner of each window in image coords.
    """
    h, w = img.shape
    half = patch // 2
    cx = jnp.clip(jnp.round(centers_xy[:, 0]).astype(jnp.int32) - half, 0, w - patch)
    cy = jnp.clip(jnp.round(centers_xy[:, 1]).astype(jnp.int32) - half, 0, h - patch)

    def one(y0, x0):
        return jax.lax.dynamic_slice(img, (y0, x0), (patch, patch))

    patches = jax.vmap(one)(cy, cx)
    return patches, jnp.stack([cx, cy], axis=-1).astype(jnp.float32)


def patch_coords(start_xy: jnp.ndarray, patch: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-patch global pixel coordinate grids ``(K, P, P)`` for (x, y)."""
    r = jnp.arange(patch, dtype=jnp.float32)
    gx = start_xy[:, 0, None, None] + r[None, None, :]
    gy = start_xy[:, 1, None, None] + r[None, :, None]
    return jnp.broadcast_to(gx, (start_xy.shape[0], patch, patch)), \
        jnp.broadcast_to(gy, (start_xy.shape[0], patch, patch))
