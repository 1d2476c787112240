"""Bring-up smoke test of the marker->pose pipeline on one GPU.

Drives the main path once through the entry points a user calls, at the
reference's capture size (640x480, ``collecting.py:27-37``) and the >480-row
detector profile (960x1280, 1080x1920), all in ONE process so a single JAX
client owns the card:

1. device   — every JAX device is a GPU; the card's name and power limit.
2. compile  — ``process_frames`` at 480x640 B=1024 and 1080x1920 B=48:
              compile seconds and ``memory_analysis()``; then the 480p step
              runs on a rendered tilted-compression ramp.
3. replay   — the ``synth`` + ``track`` + ``indent`` CLI on a >=256-frame
              staircase video, and the 960x1280 / 1080x1920 profiles.
4. decode   — ``track --device-decode`` on the committed MJPEG fixture vs
              a host decode of the same bytes, and ``run-live
              --device-decode --publish`` on an MJPEG HTTP stream of it.
5. card-cpu — detection and the full step on the GPU vs the CPU backend of
              the same process.

Every run checks 65/65 markers tracked in every frame and the error against
the synthetic ground truth; every tolerance is stated beside its check. Any
failure raises, so the script exits non-zero; the ``ok`` line is printed
only after every phase passed. Frames/s printed here are smoke figures, not
benchmark metrics.

``--four-cards`` runs only the data-parallel path over four GPUs and its
comparison with one card. ``--trace DIR`` also writes a profiler trace of
the 480p step and prints its top device operations.

    python chip_smoke.py [--four-cards] [--trace DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "data", "sensor_640x480_q70.avi")

# Against the synthetic ground truth (README "Tests & benchmarks";
# tests/test_detect.py, tests/test_reconstruct.py, tests/test_analysis.py):
# (max, median) photometric centroid error vs the projected center in px,
# and the contact-plane tilt error vs the prescribed pose in degrees. At
# 480 rows the rest pose is within 0.1 px (tests/test_detect.py); over the
# 1024-frame ramp one outer marker reaches 0.145 px (frame 964, the same
# value on the CPU and the card), the median stays at 0.008 px.
TOL_480 = (0.2, 0.05, 0.5)
# The staircase's deepest steps (7.7-8.4 mm) magnify the markers enough that
# the rendered blob's photometric center leaves the projected center by up
# to 0.11 px (0.02 px over its first nine steps; measured on the CPU).
TOL_STAIRCASE = (0.15, 0.05, None)
# Above 480 rows the reference's high-res profile (marker_detection.py:
# 117-126) sees outer-ring markers ~40 px across whose neighbour halfplane
# cuts clip them, and the clipped diameters feed depth, hence tilt.
# Measured over the ramps this script runs, the same on the CPU and an
# H100: max 1.27 px, median 0.006 px, tilt error 0.05 deg at 960x1280
# B=64; max 1.36 px, median 0.086 px, tilt error 1.00 deg at 1080x1920
# B=48 (true tilt 4.49 deg: the clipping's known 22% error). Each limit
# sits just above its reading, so a regression of the profile shows.
TOL_HIGHRES = {960: (1.4, 0.02, 0.1), 1080: (1.5, 0.1, 1.1)}
STEP_TOL_MM = 0.1         # staircase single-step displacement error
CUMULATIVE_TOL_MM = 0.5   # staircase error after all 12 steps

# Card vs CPU backend on identical inputs. Every matmul on this path runs at
# Precision.HIGHEST, so what differs is the order of float32 sums: ~1e-6
# relative. Measured on an H100 (480x640 B=8, 1080x1920 B=2): centroids
# 6.1e-5 px, world 1.9e-5 mm, tilt 2.6e-5 deg, no mask pixel differing.
# The limits leave room for one threshold pixel flipping at an exact tie
# (~0.003 px on a ~300 px blob). Axes carry more: detection measures its
# axis calibration as the median over markers of a half-level/soft ratio,
# and one pixel at the w = 0.5 half level moves that median by ~1e-3 of
# a ~20 px axis (measured 0.0187 px at 480x640).
CARD_CPU_TOL = {
    "centroid_px": 0.01,
    "axes_px": 0.05,
    "world_mm": 2e-4,
    "tilt_deg": 1e-3,
    "mask_share": 1e-4,
}

# track --device-decode vs the host decode of the same JPEG bytes: the
# device IDCT sums float32 products where the host reference uses float64.
# Flat blocks often land exactly on x.5 before rounding, so whole blocks
# round to neighbouring gray levels: <= 1 level, in ~1.2% of the fixture's
# pixels. Over the fixture's 32 frames that moved centroids by up to
# 0.194 px and axes by 0.267 px (H100, the same in every run); 8 frames on
# the CPU: 0.12 / 0.14 px. The pixel check is the strict one: a wrong IDCT
# is off by far more.
DECODE_PIXEL_TOL = 1.0
DECODE_TOL_PX = 0.35


def say(msg: str) -> None:
    print(msg, flush=True)


def require_gpu():
    """All JAX devices, which must be GPUs; exits 2 (no result) otherwise."""
    import jax
    devs = jax.devices()
    bad = [d for d in devs if d.platform != "gpu"]
    if bad:
        print(f"chip_smoke.py: needs a GPU; JAX found "
              f"{sorted({d.platform for d in devs})}", file=sys.stderr)
        sys.exit(2)
    return devs


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip()


# --------------------------------------------------------------------------
# Ground truth and checks
# --------------------------------------------------------------------------

def tilt_ramp(batch: int, height: int = 480):
    """Displacements easing from rest into a tilted compression, and the
    contact-plane tilt each frame then has (ForceDistribution.py:138-162:
    the field's plane slope scales with the ramp fraction).

    The pose is 10 deg and 0.5 mm at 480 rows and shrinks with the frame
    height, so the image motion stays inside the frame-0 association gate
    (20 px at every resolution, marker_detection.py:359)."""
    from vision_basedsensor_tpu.synth import tilt_deviation_field
    scale = 480.0 / height
    tilt_deg = float(np.degrees(np.arctan(np.tan(np.radians(10.0)) * scale)))
    compression_mm = 0.5 * scale
    frac = np.linspace(0.0, 1.0, batch, dtype=np.float32)
    field = np.asarray(tilt_deviation_field(tilt_deg,
                                            compression_mm=compression_mm))
    disp = frac[:, None, None] * field[None]
    truth = np.degrees(np.arctan(frac * np.tan(np.radians(tilt_deg))))
    return disp.astype(np.float32), truth


def true_centers(scene, disp) -> np.ndarray:
    """Projected marker centers ``(B, 65, 2)`` of the rendered frames."""
    import jax.numpy as jnp

    from vision_basedsensor_tpu.core.camera import project_points
    return np.asarray(project_points(
        scene.cam, scene.marker_world[None] + jnp.asarray(disp)))


def tolerances(height: int) -> tuple:
    return TOL_480 if height <= 480 else TOL_HIGHRES[height]


def check_tracking(name: str, xy, valid, truth_xy, tol: tuple,
                   tilt=None, truth_tilt=None) -> dict:
    """65/65 tracked in every frame, centroids (and tilt) vs ground truth."""
    xy, valid = np.asarray(xy), np.asarray(valid)
    per_frame = valid.sum(-1)
    if per_frame.min() != 65:
        raise AssertionError(f"{name}: {int(per_frame.min())}/65 markers "
                             f"tracked in frame {int(per_frame.argmin())}")
    errs = np.linalg.norm(xy - truth_xy, axis=-1)
    err, med = float(errs.max()), float(np.median(errs))
    stats = {"min_tracked": int(per_frame.min()), "frames": len(per_frame),
             "max_centroid_err_px": err, "median_centroid_err_px": med}
    if err > tol[0] or med > tol[1]:
        raise AssertionError(f"{name}: centroid error max {err:.4f} px, "
                             f"median {med:.4f} px (limits {tol[:2]})")
    if tilt is not None:
        terr = float(np.abs(np.asarray(tilt) - truth_tilt).max())
        stats["max_tilt_err_deg"] = terr
        if terr > tol[2]:
            raise AssertionError(f"{name}: tilt error {terr:.3f} deg > "
                                 f"{tol[2]}")
    say(f"[check] {name}: 65/65 tracked in all {len(per_frame)} frames, "
        + ", ".join(f"{k} {v:.6g}" for k, v in stats.items()
                    if k.startswith(("max", "median"))))
    return stats


def run_cli(argv: list[str]) -> str:
    """Run the ``vbs`` CLI in this process; returns (and echoes) its
    stdout and stderr, interleaved."""
    from vision_basedsensor_tpu.cli.main import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        say(f"  | {line}")
    return out


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def _scene_step(height: int, width: int, batch: int, device=None):
    """Rendered tilt-ramp frames, their frame-0 reference table and the
    pipeline config, for ``process_frames`` at one shape."""
    import jax

    from vision_basedsensor_tpu.config import (PipelineConfig,
                                               ReconstructConfig)
    from vision_basedsensor_tpu.pipeline import initialize
    from vision_basedsensor_tpu.synth import default_scene, render_frames

    cfg = PipelineConfig(reconstruct=ReconstructConfig(warmup_frames=0))
    scene = default_scene(height=height, width=width)
    disp, truth_tilt = tilt_ramp(batch, height)
    frames = jax.block_until_ready(render_frames(scene, disp))
    if device is not None:
        frames = jax.device_put(frames, device)
    ref = initialize(frames[0], cfg)
    return cfg, scene, frames, ref, disp, truth_tilt


def phase_compile(shapes, run_shape=None, iters: int = 3) -> dict:
    """Compile ``process_frames`` at each ``(H, W, B)``; print compile time
    and ``memory_analysis()``. Then run the ``run_shape`` step and check it."""
    import jax

    from vision_basedsensor_tpu.pipeline import process_frames

    compiled = {}
    for h, w, b in shapes:
        cfg, scene, frames, ref, disp, truth_tilt = _scene_step(h, w, 1)
        spec = jax.ShapeDtypeStruct((b, h, w), frames.dtype)
        t0 = time.perf_counter()
        exe = process_frames.lower(spec, ref, scene.cam, cfg).compile()
        dt = time.perf_counter() - t0
        say(f"[compile] process_frames {h}x{w} B={b}: {dt:.2f} s")
        say(f"[compile] memory_analysis {h}x{w} B={b}: "
            f"{exe.memory_analysis()}")
        compiled[(h, w, b)] = exe
    if run_shape is None:
        return {"compiled": compiled}
    h, w, b = run_shape
    cfg, scene, frames, ref, disp, truth_tilt = _scene_step(h, w, b)
    exe = compiled[(h, w, b)]
    out = jax.block_until_ready(exe(frames, ref, scene.cam))
    stats = check_tracking(f"process_frames {h}x{w} B={b}", out.tracked.xy,
                           out.tracked.valid, true_centers(scene, disp),
                           tolerances(h), out.contact.tilt_deg, truth_tilt)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = exe(frames, ref, scene.cam)
    jax.block_until_ready(out)
    fps = b * iters / (time.perf_counter() - t0)
    say(f"[smoke figure] process_frames {h}x{w} B={b}: {fps:.1f} frames/s "
        f"(frames already on the device; not a benchmark metric)")
    return {"compiled": compiled, "fps": fps, **stats}


def phase_replay(workdir: str, height: int = 480, width: int = 640,
                 frames_per_step: int = 22, highres=((960, 1280, 64),
                                                      (1080, 1920, 48)),
                 compiled: dict | None = None) -> dict:
    """The offline CLI on a staircase video, plus the high-res profiles."""
    import jax

    from vision_basedsensor_tpu.config import (PipelineConfig, TrackConfig,
                                               to_json)
    from vision_basedsensor_tpu.io.table import read_tracking_csv
    from vision_basedsensor_tpu.pipeline import process_frames
    from vision_basedsensor_tpu.synth import (default_scene,
                                              indentation_staircase)

    steps = 12
    n = steps * frames_per_step + 1
    video = os.path.join(workdir, "staircase.npy")
    run_cli(["synth", "--output", video, "--motion", "staircase",
             "--frames-per-step", str(frames_per_step),
             "--height", str(height), "--width", str(width)])
    # 8.4 mm of compression drifts outer markers past the frame-0 gate;
    # sequential association follows them (tests/test_reconstruct.py).
    cfg_path = os.path.join(workdir, "sequential.json")
    to_json(PipelineConfig(track=TrackConfig(association_mode="sequential")),
            cfg_path)
    out_dir = os.path.join(workdir, "track")
    run_cli(["--config", cfg_path, "track", video, "--output-dir", out_dir,
             "--chunk", str(n)])
    tab = read_tracking_csv(os.path.join(out_dir, "markers.csv"))
    if tab["xy"].shape[0] != n:
        raise AssertionError(f"markers.csv holds {tab['xy'].shape[0]} "
                             f"frames, video has {n}")
    scene = default_scene(height, width)
    disp = np.asarray(indentation_staircase(steps, 0.7, frames_per_step))
    stats = {"track": check_tracking(f"track {height}x{width} staircase",
                                     tab["xy"], tab["valid"],
                                     true_centers(scene, disp),
                                     TOL_STAIRCASE)}

    steps_csv = os.path.join(workdir, "steps.csv")
    run_cli(["indent", video, "--frames-per-step", str(frames_per_step),
             "--chunk", str(n), "--output", steps_csv])
    rows = np.loadtxt(steps_csv, delimiter=",", skiprows=1, ndmin=2)
    step_err = float(np.abs(rows[:, 4]).max())
    cum_err = float(abs(rows[-1, 3]))
    say(f"[check] indent: worst single-step error {step_err:.4f} mm "
        f"(< {STEP_TOL_MM}), cumulative {cum_err:.4f} mm "
        f"(< {CUMULATIVE_TOL_MM}), markers per step {rows[:, 5].min():.0f}")
    if step_err >= STEP_TOL_MM or cum_err >= CUMULATIVE_TOL_MM \
            or rows[:, 5].min() != 65:
        raise AssertionError("staircase outside its envelope")
    stats["indent"] = {"step_err_mm": step_err, "cumulative_err_mm": cum_err}

    for h, w, b in highres:
        cfg, scene, frames, ref, disp, truth_tilt = _scene_step(h, w, b)
        exe = (compiled or {}).get((h, w, b))
        out = (exe(frames, ref, scene.cam) if exe is not None
               else process_frames(frames, ref, scene.cam, cfg))
        out = jax.block_until_ready(out)
        stats[f"{h}x{w}"] = check_tracking(
            f"process_frames {h}x{w} B={b}", out.tracked.xy,
            out.tracked.valid, true_centers(scene, disp), tolerances(h),
            out.contact.tilt_deg, truth_tilt)
    return stats


def avi_jpegs(path: str) -> list[bytes]:
    from vision_basedsensor_tpu.io.video import _iter_avi_video_chunks
    with open(path, "rb") as f:
        return list(_iter_avi_video_chunks(f.read()))


def host_decode(jpegs: list[bytes]) -> np.ndarray:
    """Gray frames decoded on the host in float64 numpy: the native entropy
    decode, then dequantization and the 8x8 IDCT written out here — a
    libjpeg stand-in that needs neither cv2 nor PIL."""
    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    hd = MjpegBatchDecoder().entropy_decode_dense(jpegs)
    k = np.arange(8)
    a = np.cos((2 * k[:, None] + 1) * k[None, :] * np.pi / 16.0)
    a *= np.where(k == 0, np.sqrt(1.0 / 8.0), np.sqrt(2.0 / 8.0))
    coeffs = hd.coeffs.astype(np.float64) \
        * hd.qtables.astype(np.float64)[:, None, None, :]
    n, bh, bw, _ = coeffs.shape
    blocks = np.einsum("ik,nyxkl,jl->nyxij", a,
                       coeffs.reshape(n, bh, bw, 8, 8), a) + 128.0
    img = blocks.transpose(0, 1, 3, 2, 4).reshape(n, bh * 8, bw * 8)
    img = np.clip(np.floor(img + 0.5), 0, 255)
    return img[:, :hd.height, :hd.width].astype(np.uint8)


def _mjpeg_server(jpegs: list[bytes], fps: float):
    """A few lines of ``http.server`` streaming ``jpegs`` in a loop as
    multipart MJPEG at ``fps`` (the capture server's wire format)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type",
                             "multipart/x-mixed-replace; boundary=frame")
            self.end_headers()
            i = 0
            try:
                while True:
                    jb = jpegs[i % len(jpegs)]
                    self.wfile.write(
                        b"--frame\r\nContent-Type: image/jpeg\r\n"
                        b"Content-Length: %d\r\n\r\n" % len(jb) + jb
                        + b"\r\n")
                    i += 1
                    time.sleep(1.0 / fps)
            except (BrokenPipeError, ConnectionResetError):
                pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_device_decode(workdir: str, fixture: str = FIXTURE,
                        n_frames: int | None = None, batch: int = 8,
                        live_frames: int = 32) -> dict:
    """Device JPEG decode of the fixture through ``track`` and ``run-live``."""
    import urllib.request

    from vision_basedsensor_tpu.io.mjpeg import sof_dims
    from vision_basedsensor_tpu.io.table import read_tracking_csv
    from vision_basedsensor_tpu.io.video import (MjpegAviDeviceSource,
                                                 MjpegAviWriter)
    from vision_basedsensor_tpu.native import load_jpeg_lib

    if load_jpeg_lib() is None:
        raise RuntimeError("native JPEG entropy decoder did not build from "
                           "native/jpeg_coeffs.cpp")
    jpegs = avi_jpegs(fixture)[:n_frames]
    clip = os.path.join(workdir, "clip.avi")
    w, h = sof_dims(jpegs[0])
    vw = MjpegAviWriter(clip, 12.0, (w, h))
    for jb in jpegs:
        vw.write_jpeg(jb)
    vw.close()

    host = host_decode(jpegs)
    dev = np.concatenate([np.asarray(b) for b in
                          MjpegAviDeviceSource(clip).batches(batch)])
    d_px = float(np.abs(dev - host).max())
    say(f"[check] device JPEG decode vs host: max |d pixel| {d_px:g} "
        f"gray levels, {float((dev != host).mean()):.4g} of pixels differ")
    if d_px > DECODE_PIXEL_TOL:
        raise AssertionError("device JPEG decode differs from host decode")
    host_npy = os.path.join(workdir, "host_decoded.npy")
    np.save(host_npy, host)
    host_dir = os.path.join(workdir, "host")
    dev_dir = os.path.join(workdir, "device")
    run_cli(["track", host_npy, "--output-dir", host_dir, "--chunk",
             str(len(jpegs))])
    out = run_cli(["track", clip, "--output-dir", dev_dir,
                   "--device-decode", "--chunk", str(len(jpegs))])
    # The CLI falls back to host decode with a message; that is a failure.
    if "--device-decode unavailable" in out:
        raise AssertionError("track did not decode on the device")
    th = read_tracking_csv(os.path.join(host_dir, "markers.csv"))
    td = read_tracking_csv(os.path.join(dev_dir, "markers.csv"))
    if td["valid"].shape[0] != len(jpegs) or td["valid"].sum(-1).min() != 65:
        raise AssertionError("device decode: not 65/65 tracked in every "
                             "frame")
    if not (th["valid"] == td["valid"]).all():
        raise AssertionError("device vs host decode: tracked sets differ")
    d_xy = float(np.abs(td["xy"] - th["xy"]).max())
    d_axes = float(np.abs(td["axes"] - th["axes"]).max())
    say(f"[check] track --device-decode vs host decode ({len(jpegs)} "
        f"frames, 65/65 tracked): max |d centroid| {d_xy:.6g} px, "
        f"max |d axes| {d_axes:.6g} px (tolerance {DECODE_TOL_PX} px)")
    if max(d_xy, d_axes) > DECODE_TOL_PX:
        raise AssertionError("device decode differs from host decode")

    server = _mjpeg_server(jpegs, fps=12.0)
    port = _free_port()
    state: dict = {}

    def watch():
        url = f"http://127.0.0.1:{port}/state?seq=0"
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline and "body" not in state:
            try:
                with urllib.request.urlopen(url, timeout=60) as r:
                    state["body"] = json.loads(r.read())
            except OSError:
                time.sleep(0.2)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        out = run_cli(["run-live",
                       f"http://127.0.0.1:{server.server_address[1]}/",
                       "--device-decode", "--batch", str(batch),
                       "--max-frames", str(live_frames),
                       "--publish", str(port)])
    finally:
        server.shutdown()
        server.server_close()
    watcher.join(timeout=5)
    if "device-decode transport:" not in out:
        raise AssertionError("run-live did not decode on the device")
    tracked = [line for line in out.splitlines() if ": tracked " in line]
    if not tracked or any("tracked 65/65" not in t for t in tracked):
        raise AssertionError(f"run-live lost markers: {tracked}")
    if "body" not in state:
        raise AssertionError("no /state answer while run-live ran")
    say(f"[check] run-live /state: {json.dumps(state['body'])}")
    return {"decode_d_xy_px": d_xy, "decode_d_axes_px": d_axes,
            "live_batches": len(tracked), "state": state["body"]}


def phase_card_vs_cpu(shapes=((480, 640, 8), (1080, 1920, 2)),
                      card=None, cpu=None) -> dict:
    """Detection and the full step on the card vs the CPU backend."""
    import jax
    import jax.numpy as jnp

    from vision_basedsensor_tpu.core.imaging import to_grayscale
    from vision_basedsensor_tpu.detect.detector import \
        detect_markers_and_scale
    from vision_basedsensor_tpu.ops.dog import dog_area_mask
    from vision_basedsensor_tpu.ops.ncc import normxcorr_gaussian
    from vision_basedsensor_tpu.pipeline import process_frames

    card = card or jax.devices()[0]
    cpu = cpu or jax.devices("cpu")[0]
    worst = {k: 0.0 for k in CARD_CPU_TOL}
    for h, w, b in shapes:
        cfg, scene, frames, ref, disp, _ = _scene_step(h, w, b, device=cpu)
        prof = cfg.detect_profile(h)

        def run(dev):
            put = lambda t: jax.device_put(t, dev)  # noqa: E731
            f, r, cam = put(frames), put(ref), put(scene.cam)
            det, _ = detect_markers_and_scale(f, cfg.detect)
            out = process_frames(f, r, cam, cfg)
            gray = to_grayscale(f)
            area = dog_area_mask(gray, prof, cfg.detect.dog_offset)
            ncc = normxcorr_gaussian(area.astype(jnp.float32),
                                     prof.template_size, prof.template_sigma,
                                     binary_input=True)
            mask = ncc > cfg.detect.ncc_threshold
            return jax.device_get((det, out, area, mask))

        (dg, og, ag, mg), (dc, oc, ac, mc) = run(card), run(cpu)
        if not (og.tracked.valid == oc.tracked.valid).all():
            raise AssertionError(f"{h}x{w}: card and CPU track different "
                                 "markers")
        tv = og.tracked.valid
        # Candidate slots are ranked by NCC score, and near-equal scores
        # may swap ranks between backends: pair candidates by position.
        d_xy = d_axes = 0.0
        for t in range(b):
            xa = dg.xy[t][dg.valid[t]]
            xb = dc.xy[t][dc.valid[t]]
            dist = np.linalg.norm(xa[:, None] - xb[None], axis=-1)
            j = dist.argmin(1)
            if len(xa) != len(xb) or len(set(j)) != len(j):
                raise AssertionError(f"{h}x{w} frame {t}: card and CPU keep "
                                     "different candidates")
            d_xy = max(d_xy, dist[np.arange(len(j)), j].max())
            d_axes = max(d_axes, np.abs(dg.axes[t][dg.valid[t]]
                                        - dc.axes[t][dc.valid[t]][j]).max())
        d_xy = max(d_xy, np.abs(og.tracked.xy - oc.tracked.xy)[tv].max())
        diff = {
            "centroid_px": d_xy,
            "axes_px": d_axes,
            "world_mm": np.abs(og.recon.world - oc.recon.world)[tv].max(),
            "tilt_deg": np.abs(og.contact.tilt_deg
                               - oc.contact.tilt_deg).max(),
            "mask_share": max((ag != ac).mean(), (mg != mc).mean()),
        }
        say(f"[card vs cpu] {h}x{w} B={b}: "
            f"max |d centroid| {diff['centroid_px']:.3g} px, "
            f"max |d axes| {diff['axes_px']:.3g} px, "
            f"max |d world| {diff['world_mm']:.3g} mm, "
            f"max |d tilt| {diff['tilt_deg']:.3g} deg, "
            f"DoG-area pixels differing {(ag != ac).mean():.3g}, "
            f"NCC-mask pixels differing {(mg != mc).mean():.3g}, "
            f"candidates per frame {int(dg.valid.sum(-1).min())}")
        for k, val in diff.items():
            worst[k] = max(worst[k], float(val))
    over = {k: v for k, v in worst.items() if v > CARD_CPU_TOL[k]}
    if over:
        raise AssertionError(f"card vs CPU beyond tolerance: {over} "
                             f"(limits {CARD_CPU_TOL})")
    return worst


def phase_four_cards(devices, height: int = 480, width: int = 640,
                     batch: int = 1024, fixture: str = FIXTURE) -> dict:
    """``make_sharded_pipeline`` on (data=4) and (data=2, spatial=2) meshes
    vs single-card ``process_frames``; ``ShardedPackedFeed`` on the fixture."""
    import jax

    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    from vision_basedsensor_tpu.parallel import (ShardedPackedFeed,
                                                 collective_ops_in_hlo,
                                                 make_mesh,
                                                 make_sharded_pipeline,
                                                 shard_frames)
    from vision_basedsensor_tpu.pipeline import process_frames

    cfg, scene, frames, ref, disp, truth_tilt = _scene_step(
        height, width, batch, device=devices[0])
    single = jax.device_get(process_frames(frames, ref, scene.cam, cfg))
    check_tracking(f"single card {height}x{width} B={batch}",
                   single.tracked.xy, single.tracked.valid,
                   true_centers(scene, disp), tolerances(height),
                   single.contact.tilt_deg, truth_tilt)
    stats = {}
    for spatial in (1, 2):
        mesh = make_mesh(devices, spatial=spatial)
        name = "x".join(f"{a}={n}" for a, n in zip(mesh.axis_names,
                                                   mesh.devices.shape))
        step = make_sharded_pipeline(mesh, scene.cam, cfg)
        fr = shard_frames(np.asarray(frames), mesh)
        ref_r = jax.device_put(ref)
        if spatial == 1:
            ops = collective_ops_in_hlo(step, fr, ref_r)
            say(f"[four cards] collectives in the ({name}) step: {ops}")
            # Only all-gathers of the replicated (B, 65) scan state and its
            # products (tests/test_parallel.py); no pixel tensor crosses.
            if not ops or any(not o.startswith("all-gather") for o in ops) \
                    or len(ops) > 24:
                raise AssertionError(f"unexpected collectives: {ops}")
            stats["collectives"] = ops
        out = jax.device_get(step(fr, ref_r))
        # World positions within 1e-3 mm (tests/test_parallel.py): sharded
        # filters sum in another order than the single-card ones.
        d = float(np.abs(out.recon.world - single.recon.world).max())
        same = bool((out.recon.seen == single.recon.seen).all())
        say(f"[four cards] ({name}) vs single card: max |d world| {d:.3g} "
            f"mm, same seen set {same}")
        if d > 1e-3 or not same:
            raise AssertionError(f"({name}) mesh differs from one card")
        stats[name] = d

    jpegs = avi_jpegs(fixture)
    mesh = make_mesh(devices)
    sharded = np.asarray(ShardedPackedFeed(mesh).decode_packed(jpegs))
    one = np.asarray(MjpegBatchDecoder().decode_packed(jpegs))
    if sharded.shape != one.shape or not (sharded == one).all():
        raise AssertionError("ShardedPackedFeed differs from one-card decode")
    say(f"[four cards] ShardedPackedFeed: {len(jpegs)} fixture frames, "
        "bitwise equal to one-card decode")
    return stats


def trace_step(trace_dir: str, exe, height: int, width: int, batch: int,
               top: int = 15) -> None:
    """Profile three runs of the compiled step ``exe``; print the device's
    busy time, idle share and top operations."""
    import glob

    import jax

    _, scene, frames, ref, _, _ = _scene_step(height, width, batch)
    jax.block_until_ready(exe(frames, ref, scene.cam))
    with jax.profiler.trace(trace_dir):
        for _ in range(3):
            jax.block_until_ready(exe(frames, ref, scene.cam))
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    prof = jax.profiler.ProfileData.from_file(path)
    lines = [(ln.name, list(ln.events)) for plane in prof.planes
             if plane.name.startswith("/device:GPU") for ln in plane.lines]
    for name, evs in lines:
        say(f"[trace] GPU line {name!r}: {len(evs)} events, "
            f"{sum(e.duration_ns for e in evs) / 1e6:.3f} ms")
    # Kernel launches sit on the stream lines; the module and op lines
    # above them span the same time again.
    kernels = [e for name, evs in lines if "stream" in name.lower()
               for e in evs] or [e for _, evs in lines for e in evs]
    totals: dict[str, float] = {}
    for e in kernels:
        totals[e.name] = totals.get(e.name, 0.0) + e.duration_ns
    spans = sorted((e.start_ns, e.end_ns) for e in kernels)
    busy, gaps, (cur_s, cur_e) = 0.0, [], spans[0]
    for st, en in spans[1:]:
        if st > cur_e:
            busy += cur_e - cur_s
            gaps.append(st - cur_e)
            cur_s, cur_e = st, en
        else:
            cur_e = max(cur_e, en)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    say(f"[trace] {path}: 3 steps {height}x{width} B={batch}; device busy "
        f"{busy / 1e6:.3f} ms of a {window / 1e6:.3f} ms window (idle share "
        f"{1 - busy / window:.4f})")
    # Two gaps lie between the three steps; the rest are inside a step.
    gaps.sort(reverse=True)
    say(f"[trace] idle gaps: {len(gaps)}, the two largest "
        f"{', '.join(f'{g / 1e6:.3f}' for g in gaps[:2])} ms, the rest "
        f"{sum(gaps[2:]) / 1e6:.3f} ms together")
    total = sum(totals.values())
    for name, ns in sorted(totals.items(), key=lambda kv: -kv[1])[:top]:
        say(f"[trace] {ns / 3e6:10.3f} ms/step {100 * ns / total:5.1f}%  "
            f"{name[:110]}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the data-parallel path on four GPUs")
    p.add_argument("--trace", metavar="DIR",
                   help="also profile the 480p step into DIR")
    args = p.parse_args(argv)

    # The card-vs-CPU phase needs the CPU backend beside the GPU one; this
    # runs before anything imports jax.
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    devs = require_gpu()
    import jax

    from vision_basedsensor_tpu.utils.cache import enable_compile_cache
    cache = enable_compile_cache()
    t_start = time.perf_counter()
    say(f"[device] {len(devs)} x {devs[0].device_kind} "
        f"(jax {jax.__version__}, compile cache {cache})")
    say(card_line())

    with tempfile.TemporaryDirectory() as workdir:
        if args.four_cards:
            if len(devs) < 4:
                raise SystemExit(f"--four-cards needs 4 GPUs, found "
                                 f"{len(devs)}")
            devs = devs[:4]
            phase_four_cards(devs)
        else:
            t0 = time.perf_counter()
            comp = phase_compile([(480, 640, 1024), (1080, 1920, 48)],
                                 run_shape=(480, 640, 1024))
            say(f"[phase] compile: {time.perf_counter() - t0:.1f} s")
            if args.trace:
                trace_step(args.trace, comp["compiled"][(480, 640, 1024)],
                           480, 640, 1024)
            t0 = time.perf_counter()
            phase_replay(workdir, compiled=comp["compiled"])
            say(f"[phase] replay: {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            phase_device_decode(workdir)
            say(f"[phase] decode + live: {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            phase_card_vs_cpu(card=devs[0])
            say(f"[phase] card vs cpu: {time.perf_counter() - t0:.1f} s")
    say(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
