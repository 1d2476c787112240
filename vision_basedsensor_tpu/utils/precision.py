"""Double-precision scope for host-side calibration solvers.

The Zhang refinement and the PnP DLT/Gauss-Newton run their linear algebra in
float64 (``calibrate/zhang.py``, ``calibrate/pnp.py``) — the cv2-parity
accuracy they are validated to holds only at that precision. JAX silently
downcasts float64 to float32 unless x64 mode is on, and production entry
points (CLI) don't go through the test conftest that enables it globally. So
the calibration entry points opt in locally: ``@with_x64`` scopes
``jax.enable_x64`` around the call, leaving the hot pipeline (which is
deliberately f32/bf16) untouched.

Calibration runs once per sensor setup, off the hot path; the cost of f64
arithmetic is irrelevant there.
"""
from __future__ import annotations

import functools

import jax


def with_x64(fn):
    """Run ``fn`` under ``jax.enable_x64(True)`` (idempotent if already on)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.enable_x64(True):
            return fn(*args, **kwargs)
    return wrapper
