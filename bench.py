"""End-to-end throughput benchmarks on the GPU.

Each measurement prints one JSON line naming the device it ran on; the
flagship compute metric is the LAST line. Without a GPU the script exits
non-zero before measuring anything, and any failed measurement makes it
exit non-zero after the rest have run.

1. ``sustained_fps_decode_fed`` — the full production ingest path: an MJPG
   ``.avi`` on disk (the reference's actual input format,
   ``marker_detection.py:52``; MJPEG is what the capture server streams,
   ``collecting.py:130``) -> parallel host JPEG decode (io/video.py
   MjpegAviSource) -> double-buffered device feed -> the complete pipeline.
   Host decode and device compute overlap; this is the number a deployment
   actually sustains end to end.

2. ``marker_to_pose_pipeline_fps_single_chip`` — the device step alone with
   frames staged in device memory: batched frames -> detection -> association -> 3D
   displacement field -> per-frame contact-plane tilt (the full
   marker->force+pose perception step, C4..C15 including the analysis
   stage). North star: 1000 fps (BASELINE.json; the reference publishes no
   throughput and captures at 12 fps on a Raspberry Pi).
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time


_DEVICE: dict = {}


def _require_gpu() -> dict:
    """The device every line is measured on; exits non-zero without a GPU.

    A measurement that found no accelerator would time XLA's CPU backend,
    which nobody deploys, so there is no fallback."""
    import jax

    from vision_basedsensor_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench.py: no GPU found (jax.devices()[0].platform is "
              f"{devs[0].platform!r}); nothing measured", file=sys.stderr)
        sys.exit(2)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _emit(obj: dict) -> None:
    """Print one JSON metric line, naming its device, and flush at once so
    a later failure never erases an already-measured number."""
    print(json.dumps({**obj, "device": _DEVICE}), flush=True)


def _render_sequence(batch):
    """Realistic moving sequence (not timed)."""
    import jax
    import jax.numpy as jnp

    from vision_basedsensor_tpu.synth import default_scene, render_frames

    scene = default_scene(height=480, width=640)
    d = jnp.zeros((batch, 65, 3), jnp.float32)
    d = d.at[:, :, 2].add(-0.002 * jnp.arange(batch)[:, None])
    frames = jax.block_until_ready(render_frames(scene, d))
    return scene, frames


def bench_compute(batch: int, iters: int) -> float:
    import jax

    from vision_basedsensor_tpu.config import PipelineConfig, ReconstructConfig
    from vision_basedsensor_tpu.pipeline import initialize, process_frames

    cfg = PipelineConfig(reconstruct=ReconstructConfig(warmup_frames=0))
    scene, frames = _render_sequence(batch)
    ref = initialize(frames[0], cfg)

    fwd = jax.jit(lambda f, r: process_frames(f, r, scene.cam, cfg))
    out = jax.block_until_ready(fwd(frames, ref))  # compile
    for _ in range(2):  # warm
        out = jax.block_until_ready(fwd(frames, ref))

    t0 = time.perf_counter()
    for _ in range(iters):
        out = fwd(frames, ref)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return batch * iters / dt


def bench_decode_fed(n_frames: int, batch: int) -> dict | None:
    """Returns {sustained_fps, decode_only_fps, backend}. Needs cv2 to
    encode the stream."""
    import numpy as np

    import jax

    from vision_basedsensor_tpu.config import PipelineConfig, ReconstructConfig
    from vision_basedsensor_tpu.io.video import (
        MjpegAviDeviceSource, MjpegAviSource, device_feed)
    from vision_basedsensor_tpu.pipeline import initialize, process_frames

    cfg = PipelineConfig(reconstruct=ReconstructConfig(warmup_frames=0))

    # Write the bench video (setup, not timed): JPEG quality 70, exactly the
    # capture server's stream encoding (``collecting.py:130`` — the operator
    # records that stream to .avi, so q70 IS the production input; cv2's
    # VideoWriter ignores VIDEOWRITER_PROP_QUALITY in this build and wrote
    # ~q95 frames in rounds 2-4, overstating the production byte cost).
    # MjpegAviWriter muxes the encoded JPEGs verbatim, like the recorder.
    import cv2

    from vision_basedsensor_tpu.io.video import MjpegAviWriter

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "bench.avi")
        vw = MjpegAviWriter(path, 12.0, (640, 480))
        scene = None
        for start in range(0, n_frames, 256):
            scene, chunk = _render_sequence(min(256, n_frames - start))
            for f in np.asarray(chunk).astype(np.uint8):
                bgr = np.repeat(f[..., None], 3, axis=-1)  # camera frames are color
                vw.write_jpeg(cv2.imencode(
                    ".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 70])[1].tobytes())
        vw.close()

        # Five ingest backends; report the best sustained number.
        # - host_libjpeg: parallel cv2.imdecode -> raw gray frames to device.
        # - device_idct_split: native C++ entropy decode -> DC/AC-separated
        #   byte streams (~28 KB/frame at 480p q70) -> per-frame DC cumsum
        #   + sorted AC scatter + dequant+IDCT on the device. The host does
        #   only the serial Huffman work.
        # - device_idct_split_z15: the same transport under the DETECT-GRADE
        #   zigzag band limit (zmax=15 keeps every DCT mode with k+l <= 4;
        #   the pipeline's own sigma>=4.56 blurs attenuate the dropped tail
        #   below 1e-9, and tests/test_jpeg.py pins the end-to-end detect
        #   envelope). ~19 KB/frame.
        # - device_idct_packed: the 2-byte (gap, value) delta-pair transport
        #   (kept as the sparse-format ablation).
        # - device_idct: the DENSE coefficient tensor (614 KB/frame at 480p;
        #   kept as the transport ablation).
        # A device source that cannot be built (e.g. the native decoder did
        # not compile) lands in ``errors`` and fails the run.
        def sources():
            yield "host_libjpeg", lambda: MjpegAviSource(path, gray=True)
            # tdelta: temporal coefficient deltas (round 5) — the
            # production default; ~2.8 KB/frame on this stream (the
            # sensor scene IS the slow-motion workload the reference
            # records), lossless, degrading boundedly on noise.
            yield ("device_idct_tdelta",
                   lambda: MjpegAviDeviceSource(path, transport="tdelta"))
            yield ("device_idct_split_z15",
                   lambda: MjpegAviDeviceSource(path, transport="split",
                                                zmax=15))
            yield ("device_idct_split",
                   lambda: MjpegAviDeviceSource(path, transport="split"))
            yield ("device_idct_packed",
                   lambda: MjpegAviDeviceSource(path, transport="packed"))
            yield ("device_idct",
                   lambda: MjpegAviDeviceSource(path, transport="dense"))

        import jax.numpy as jnp

        results = {}
        bytes_per_frame = {}
        errors = {}
        for backend, make in sources():
          try:  # one backend failing must not erase the others' numbers
            src = make()
            on_device = backend.startswith("device")
            # Decode-only throughput. The first batch runs BEFORE the
            # timer: it compiles the decode jits, a one-time cost, not
            # throughput. The acc chain makes every device batch's
            # execution a data dependency of the final host read.
            it = src.batches(batch)
            first = next(it)
            acc = jnp.float32(0.0)
            if on_device:
                jax.block_until_ready(first)
            t0 = time.perf_counter()
            n_dec = 0
            for b in it:
                if on_device:
                    acc = acc + b[0, 0, 0] * 1e-30
                n_dec += b.shape[0]
            float(np.asarray(acc))
            decode_fps = n_dec / max(time.perf_counter() - t0, 1e-9)
            stats = getattr(src, "last_stats", None)
            if stats:
                bytes_per_frame[backend] = stats["bytes_shipped"] / stats["frames"]
            elif not on_device:
                bytes_per_frame[backend] = 640 * 480  # raw gray frames

            ref = initialize(jnp.asarray(first[0]), cfg)
            fwd = jax.jit(lambda f, s, r: process_frames(f + 1e-30 * s, r,
                                                         scene.cam, cfg))
            jax.block_until_ready(fwd(jnp.asarray(first), acc, ref))

            # MEDIAN of three sustained passes: host availability swings
            # run to run, so a single noisy window shouldn't stand as THE
            # number for a steady-state-throughput metric.
            passes = []
            for _ in range(3):
                src = make()
                t0 = time.perf_counter()
                n = 0
                for dev_batch in device_feed(src, batch):
                    out = fwd(dev_batch, acc, ref)
                    acc = out.contact.tilt_deg[-1] * 1e-30
                    n += dev_batch.shape[0]
                float(np.asarray(acc))  # force the whole chain
                passes.append(n / (time.perf_counter() - t0))
            results[backend] = (sorted(passes)[1], decode_fps)
          except Exception as e:  # noqa: BLE001
            errors[backend] = str(e)[:300]

    if not results:
        raise RuntimeError(f"all ingest backends failed: {errors}")
    # The HEADLINE is the best EXACT-decode backend; the detect-grade
    # band-limited profile (z15) reports alongside but never headlines —
    # its measured photometric-diameter cost (tests/test_jpeg.py) makes it
    # an opt-in profile, not the production default.
    exact = {k: v for k, v in results.items() if "_z" not in k}
    best = max(exact or results, key=lambda k: results[k][0])
    return {"sustained_fps": results[best][0],
            "decode_only_fps": results[best][1], "backend": best,
            "all": {k: [round(v[0], 1), round(v[1], 1)]
                    for k, v in results.items()},
            "errors": errors,
            "bytes_per_frame": {k: round(v) for k, v in
                                bytes_per_frame.items()}}


def bench_latency(batches=(1, 8, 32), iters: int = 50) -> dict:
    """Per-request serving latency: host frames -> device -> full pipeline
    -> contact-state tilt back on host. This is the number the robot-side
    pose-compensation loop (io/publish.py, README.md:124) actually sees —
    throughput at B=1024 says nothing about it.

    Frames ship as uint8 (what every real source yields — camera, MJPEG,
    .avi; the pipeline casts on device), so the host->device transfer is
    the honest 1 byte/px, not 4.

    Every iteration gets a distinct scalar input folded into the frames
    below f32 ulp and ends with a real device->host read of the tilt
    output, which is exactly the serving round trip.
    """
    import numpy as np

    import jax
    import jax.numpy as jnp

    from vision_basedsensor_tpu.config import PipelineConfig, ReconstructConfig
    from vision_basedsensor_tpu.pipeline import initialize, process_frames

    cfg = PipelineConfig(reconstruct=ReconstructConfig(warmup_frames=0))
    scene, frames = _render_sequence(max(batches))
    ref = initialize(frames[0], cfg)

    @jax.jit
    def step(f, s, r):
        out = process_frames(f.astype(jnp.float32) + 1e-30 * s, r,
                             scene.cam, cfg)
        return out.contact.tilt_deg[-1]

    results = {}
    for b in batches:
        fnp = np.asarray(frames[:b]).astype(np.uint8)
        s = float(np.asarray(step(jnp.asarray(fnp), jnp.float32(0.0), ref)))
        times = []
        for i in range(iters):
            t0 = time.perf_counter()
            dev = jax.device_put(fnp)
            s = float(np.asarray(step(dev, jnp.float32(i + s * 1e-6), ref)))
            times.append(time.perf_counter() - t0)
        times.sort()
        results[f"b{b}"] = {
            "p50_ms": round(times[len(times) // 2] * 1e3, 2),
            "p99_ms": round(times[min(len(times) - 1,
                                      int(len(times) * 0.99))] * 1e3, 2),
        }
    return results


def bench_latency_packed(iters: int = 50) -> dict | None:
    """B=1 serving latency on the LIVE-STREAM transport: JPEG bytes (as the
    MJPEG stream delivers them) -> native entropy decode -> SPLIT sparse
    streams over the link (the shipping default transport) -> on-device
    expand + IDCT -> full pipeline -> tilt on host. This ships ~25-35 KB
    instead of 307 KB/frame; pair with bench_latency's b1 row. Needs cv2
    (JPEG encode for the fixture) and the native decoder.
    """
    import numpy as np

    import jax
    import jax.numpy as jnp

    import cv2

    from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
    dec = MjpegBatchDecoder()

    from vision_basedsensor_tpu.config import PipelineConfig, ReconstructConfig
    from vision_basedsensor_tpu.pipeline import initialize, process_frames

    cfg = PipelineConfig(reconstruct=ReconstructConfig(warmup_frames=0))
    scene, frames = _render_sequence(iters + 1)
    jpegs = [cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, 70])[1]
             .tobytes() for f in np.asarray(frames).astype(np.uint8)]
    ref = initialize(frames[0], cfg)

    @jax.jit
    def step(f, r):
        out = process_frames(f, r, scene.cam, cfg)
        return out.contact.tilt_deg[-1]

    # Warm both jits (expand buckets + pipeline) on the first frame.
    float(np.asarray(step(dec.decode_split([jpegs[0]]), ref)))
    times = []
    for i in range(iters):
        t0 = time.perf_counter()
        dev = dec.decode_split([jpegs[i + 1]])  # distinct frame each iter
        float(np.asarray(step(dev, ref)))
        times.append(time.perf_counter() - t0)
    times.sort()
    return {"p50_ms": round(times[len(times) // 2] * 1e3, 2),
            "p99_ms": round(times[min(len(times) - 1,
                                      int(len(times) * 0.99))] * 1e3, 2)}


def bench_highres(height: int, width: int, batch: int, iters: int = 6
                  ) -> dict:
    """Full marker->pose pipeline fps under the reference's >480p detector
    profile (``marker_detection.py:118-124``: blur 101 sigma 20, template
    l=80 sigma 13, threshold 20). Reports the fewest markers tracked in
    any frame."""
    import numpy as np

    import jax
    import jax.numpy as jnp

    from vision_basedsensor_tpu.config import PipelineConfig, ReconstructConfig
    from vision_basedsensor_tpu.pipeline import initialize, process_frames
    from vision_basedsensor_tpu.synth import default_scene, render_frames

    cfg = PipelineConfig(reconstruct=ReconstructConfig(warmup_frames=0))
    scene = default_scene(height=height, width=width)
    d = jnp.zeros((batch, 65, 3), jnp.float32)
    d = d.at[:, :, 2].add(-0.002 * jnp.arange(batch)[:, None])
    frames = jax.block_until_ready(render_frames(scene, d))
    ref = initialize(frames[0], cfg)
    n_ref = int(np.asarray(ref.valid).sum())

    fwd = jax.jit(lambda f, r: process_frames(f, r, scene.cam, cfg))
    out = jax.block_until_ready(fwd(frames, ref))
    tracked = int(np.asarray(out.tracked.valid).sum(-1).min())
    for _ in range(2):
        out = jax.block_until_ready(fwd(frames, ref))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fwd(frames, ref)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return {"fps": round(batch * iters / dt, 1), "ref_markers": n_ref,
            "min_tracked": tracked}


def bench_link(mb: int = 13, reps: int = 3) -> dict:
    """Effective host->device copy bandwidth (context for decode-fed: a
    link-bound transport's sustained fps tracks bytes/frame x this)."""
    import jax
    import numpy as np

    x = np.random.default_rng(0).integers(
        0, 255, size=(mb * 1024 * 1024,), dtype=np.uint8)
    d = jax.device_put(x)
    jax.block_until_ready(d)  # warm
    best = 0.0
    for rep in range(reps):
        t0 = time.perf_counter()
        d = jax.device_put(x ^ np.uint8(rep + 1))  # distinct, no dedup
        jax.block_until_ready(d)
        best = max(best, mb / (time.perf_counter() - t0))
    return {"h2d_MBps": round(best, 1)}


def main() -> None:
    """Run every benchmark, emitting each JSON metric line the moment it is
    measured and guarding each benchmark independently. The flagship
    compute metric is measured first and re-emitted LAST. Exits 2 without
    a GPU and 1 if any benchmark failed."""
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    _DEVICE.update(_require_gpu())

    failures = 0

    # 1. Flagship compute number, emitted now AND re-emitted last.
    flagship = None
    try:
        fps = bench_compute(batch, iters)
        flagship = {
            "metric": "marker_to_pose_pipeline_fps_single_chip",
            "value": round(fps, 1),
            "unit": "frames/sec (640x480)",
            "vs_baseline": round(fps / 1000.0, 3),
        }
        _emit(flagship)
    except Exception as e:  # noqa: BLE001
        failures += 1
        _emit({"metric": "marker_to_pose_pipeline_fps_single_chip",
               "error": str(e)[:500]})

    # 2. Production ingest path (decode-fed), with the host->device copy
    #    bandwidth beside it.
    link = None
    try:
        link = bench_link()
        _emit({"metric": "h2d_link_bandwidth", "value": link["h2d_MBps"],
               "unit": "MB/s host->device", "vs_baseline": 1.0})
    except Exception as e:  # noqa: BLE001
        failures += 1
        _emit({"metric": "h2d_link_bandwidth", "error": str(e)[:300]})
    try:
        decode = bench_decode_fed(n_frames=2048, batch=256)
        if link is not None:
            decode["link_MBps"] = link["h2d_MBps"]
        # Link-bound ceiling per backend: bytes/frame x measured MB/s.
        bound = None
        if link is not None:
            bound = {k: round(link["h2d_MBps"] * 1e6 / v, 1)
                     for k, v in decode["bytes_per_frame"].items() if v}
        _emit({
            "metric": "sustained_fps_decode_fed",
            "value": round(decode["sustained_fps"], 1),
            "unit": "frames/sec (640x480 q70 MJPG avi -> decode -> device)",
            "vs_baseline": round(decode["sustained_fps"] / 1000.0, 3),
            "decode_only_fps": round(decode["decode_only_fps"], 1),
            "decode_backend": decode["backend"],
            "backends": decode["all"],
            "backend_errors": decode["errors"],
            "bytes_per_frame": decode["bytes_per_frame"],
            "link_MBps": decode.get("link_MBps"),
            "link_bound_fps": bound,
        })
        if decode["errors"]:
            failures += 1
    except Exception as e:  # noqa: BLE001
        failures += 1
        _emit({"metric": "sustained_fps_decode_fed", "error": str(e)[:500]})

    # 3. High-res profile (the reference's >480p detector constants).
    for hh, ww, bb in ((960, 1280, 64), (1080, 1920, 48)):
        try:
            hr = bench_highres(hh, ww, bb)
            _emit({
                "metric": f"pipeline_fps_{hh}x{ww}",
                "value": hr["fps"],
                "unit": f"frames/sec ({hh}x{ww}, B={bb}, full pipeline)",
                "vs_baseline": round(hr["fps"] / 1000.0, 3),
                "ref_markers": hr["ref_markers"],
                "min_tracked_per_frame": hr["min_tracked"],
            })
        except Exception as e:  # noqa: BLE001
            failures += 1
            _emit({"metric": f"pipeline_fps_{hh}x{ww}",
                   "error": str(e)[:500]})

    # 4. Serving latency (B=1/8/32 + split-transport B=1).
    try:
        lat = bench_latency()
        try:
            lat["b1_jpeg_split"] = bench_latency_packed()
        except Exception as e:  # noqa: BLE001
            failures += 1
            lat["b1_jpeg_split"] = {"error": str(e)[:300]}
        _emit({
            "metric": "serving_latency_ms",
            "value": lat["b1"]["p50_ms"],
            "unit": "ms p50 end-to-end at B=1 "
                    "(host->device->detect->pose->host)",
            "vs_baseline": lat["b1"]["p50_ms"],
            "latency": lat,
        })
    except Exception as e:  # noqa: BLE001
        failures += 1
        _emit({"metric": "serving_latency_ms", "error": str(e)[:500]})

    if flagship is not None:
        _emit(flagship)
    if failures:
        print(f"bench.py: {failures} benchmark(s) failed; see the error "
              "lines above", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
