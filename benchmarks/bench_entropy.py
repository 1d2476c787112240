"""Micro-benchmark for the native JPEG entropy decoder (host-only).

The decode-fed production path's host budget is dominated by
``vbs_mjpeg_batch_y_coeffs_delta`` (native/jpeg_coeffs.cpp) — on a host
with few cores the entropy decode IS the ingest wall, so its per-frame cost
bounds sustained_fps_decode_fed. Run this before/after decoder changes:

    JAX_PLATFORMS=cpu python benchmarks/bench_entropy.py [n_frames] [threads]

No accelerator needed: frames render on the CPU and nothing touches the
device path.
"""
from __future__ import annotations

import ctypes
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def make_jpegs(n: int) -> list[bytes]:
    import cv2

    import jax.numpy as jnp

    from vision_basedsensor_tpu.synth import default_scene, render_frames

    scene = default_scene(height=480, width=640)
    d = jnp.zeros((n, 65, 3), jnp.float32)
    d = d.at[:, :, 2].add(-0.002 * jnp.arange(n)[:, None])
    frames = np.asarray(render_frames(scene, d)).astype(np.uint8)
    return [cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, 70])[1]
            .tobytes() for f in frames]


def bench_delta(jpegs: list[bytes], threads: int = 1, reps: int = 5) -> None:
    from vision_basedsensor_tpu.native import load_jpeg_lib

    lib = load_jpeg_lib()
    assert lib is not None, "native decoder unavailable"
    n = len(jpegs)
    data = b"".join(jpegs)
    offsets = np.zeros(n, np.int64)
    sizes = np.zeros(n, np.int32)
    pos = 0
    for i, j in enumerate(jpegs):
        offsets[i] = pos
        sizes[i] = len(j)
        pos += len(j)

    meta = (ctypes.c_int32 * 4)()
    q = (ctypes.c_uint16 * 64)()
    buf = np.empty(((1920 // 8) * (1088 // 8), 64), np.int16)
    rc = lib.vbs_jpeg_y_coeffs(jpegs[0], len(jpegs[0]),
                               buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                               buf.shape[0], meta, q)
    assert rc == 0, rc
    blocks = meta[2] * meta[3]

    cap = 8 * blocks * n
    scap = max(blocks * n // 8, 1 << 12)
    gaps = np.empty(cap, np.uint8)
    vals = np.empty(cap, np.int8)
    sgaps = np.empty(scap, np.uint8)
    sdeltas = np.empty(scap, np.int16)
    qtables = np.empty((n, 64), np.uint16)
    counts = np.zeros(2, np.int64)
    fn_mt = getattr(lib, "vbs_mjpeg_batch_y_coeffs_delta_mt", None)

    def run() -> int:
        args = (data,
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
                gaps.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), cap,
                sgaps.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                sdeltas.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), scap,
                counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                blocks, meta,
                qtables.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
        if threads > 1 and fn_mt is not None:
            return fn_mt(*args, threads)
        return lib.vbs_mjpeg_batch_y_coeffs_delta(*args)

    got = run()  # warm page cache
    assert got == n, got
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        got = run()
        dt = time.perf_counter() - t0
        assert got == n, got
        best = min(best, dt)
    nnz = int(counts[0])
    print(f"entropy decode: {n} frames, {best * 1e3 / n:.3f} ms/frame, "
          f"{n / best:.0f} fps ({threads} thread(s), "
          f"{nnz / n:.0f} entries/frame, "
          f"{sum(sizes) / n / 1024:.1f} KB/frame jpeg)")


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    threads = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    bench_delta(make_jpegs(n), threads)
