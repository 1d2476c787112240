"""Writer of the committed MJPEG fixture ``tests/data/sensor_640x480_q70.avi``.

The fixture stands in for a recorded sensor stream wherever cv2 and PIL may
be missing (``chip_smoke.py``'s device-decode and live-serving phases,
``--four-cards`` ingest): 640x480 JPEG quality 70, the reference's capture
settings (``collecting.py:27-37``), muxed verbatim by the repo's own
``MjpegAviWriter`` like a recording of the capture server's stream. The
frames are the benchmark's rendered sequence: the dome at rest, compressing
by 2 um per frame. Regenerate (needs cv2) with:

    python tests/mjpeg_fixture.py
"""
from __future__ import annotations

import os
import sys

import numpy as np

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "sensor_640x480_q70.avi")
N_FRAMES = 32
HEIGHT, WIDTH, QUALITY = 480, 640, 70


def fixture_frames(n_frames: int = N_FRAMES) -> np.ndarray:
    """The fixture's uint8 gray frames before JPEG encoding."""
    import jax.numpy as jnp

    from vision_basedsensor_tpu.synth import default_scene, render_frames

    scene = default_scene(height=HEIGHT, width=WIDTH)
    d = jnp.zeros((n_frames, 65, 3), jnp.float32)
    d = d.at[:, :, 2].add(-0.002 * jnp.arange(n_frames)[:, None])
    return np.asarray(render_frames(scene, d)).astype(np.uint8)


def write_fixture(path: str = FIXTURE, n_frames: int = N_FRAMES) -> None:
    import cv2

    from vision_basedsensor_tpu.io.video import MjpegAviWriter

    os.makedirs(os.path.dirname(path), exist_ok=True)
    vw = MjpegAviWriter(path, 12.0, (WIDTH, HEIGHT))
    for f in fixture_frames(n_frames):
        bgr = np.repeat(f[..., None], 3, axis=-1)  # camera frames are color
        vw.write_jpeg(cv2.imencode(
            ".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, QUALITY])[1].tobytes())
    vw.close()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    write_fixture()
    print(f"wrote {FIXTURE} ({os.path.getsize(FIXTURE)} bytes)")
