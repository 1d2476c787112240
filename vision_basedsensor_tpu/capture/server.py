"""Acquisition server: LED ring control + camera capture + MJPEG streaming.

Feature parity with the reference's online stage (C1-C3,
``code/Vedio_Capture/collecting.py``): a WS281x LED ring driven white during
capture (simulated when the hardware library is absent, like
``collecting.py:12-24``), a V4L2 camera opened with retries and MJPG fourcc
(``:91-109``), a background capture thread publishing JPEG-encoded frames
into a latest-value mailbox (``:111-131`` — whole-object replacement, so the
capture-thread/server-thread race is benign by design, SURVEY.md §5.2), and a
threaded HTTP server exposing ``/`` (HTML) and ``/stream``
(``multipart/x-mixed-replace`` MJPEG) on the configured port (``:153-195``).

Differences from the reference: no root requirement unless LEDs are real
(GPIO access is what needed root), port/camera/LED settings come from the
typed CaptureConfig, and a ``SyntheticCamera`` can serve rendered dome frames
for hardware-free end-to-end testing.
"""
from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from vision_basedsensor_tpu.config import CaptureConfig

try:
    import cv2 as _cv2
except Exception:  # pragma: no cover
    _cv2 = None

try:  # hardware LED library, present only on a Raspberry Pi
    from rpi_ws281x import PixelStrip as _PixelStrip, Color as _Color  # type: ignore
    _HAS_LED_HW = True
except Exception:
    _PixelStrip = None
    _Color = None
    _HAS_LED_HW = False


class LedRing:
    """WS281x ring controller; simulated when the library is absent."""

    def __init__(self, cfg: CaptureConfig):
        self.cfg = cfg
        self.simulated = not _HAS_LED_HW
        self._pixels = [(0, 0, 0)] * cfg.led_count
        self._strip = None
        if _HAS_LED_HW:  # pragma: no cover - hardware only
            try:
                self._strip = _PixelStrip(cfg.led_count, cfg.led_pin,
                                          brightness=cfg.led_brightness)
                self._strip.begin()
            except Exception as e:
                print(f"[LED] init failed, simulating: {e}")
                self._strip = None
                self.simulated = True

    def _show(self) -> None:
        if self._strip is not None:  # pragma: no cover
            try:
                for i, (r, g, b) in enumerate(self._pixels):
                    self._strip.setPixelColor(i, _Color(r, g, b))
                self._strip.show()
            except Exception as e:
                print(f"[LED] update failed: {e}")

    def set_all(self, rgb: tuple[int, int, int]) -> None:
        self._pixels = [rgb] * self.cfg.led_count
        self._show()

    def all_white(self) -> None:
        self.set_all((255, 255, 255))

    def off(self) -> None:
        self.set_all((0, 0, 0))


def _encode_jpeg(frame: np.ndarray, quality: int) -> bytes:
    if _cv2 is not None:
        ok, buf = _cv2.imencode(".jpg", frame,
                                [_cv2.IMWRITE_JPEG_QUALITY, quality])
        if ok:
            return buf.tobytes()
    try:  # PIL fallback
        import io as _io

        from PIL import Image
        img = Image.fromarray(frame[..., ::-1] if frame.ndim == 3 else frame)
        b = _io.BytesIO()
        img.save(b, format="JPEG", quality=quality)
        return b.getvalue()
    except Exception as e:  # pragma: no cover
        raise RuntimeError("No JPEG encoder available (need cv2 or PIL)") from e


class SyntheticCamera:
    """Frame generator fallback: either a rendered dome scene or the
    "NO CAMERA" test pattern (collecting.py:133-142 analog)."""

    def __init__(self, cfg: CaptureConfig, scene=None):
        self.cfg = cfg
        if scene is not None:
            # A camera is a HOST device: its renders run on the CPU, not
            # the compute device. read() runs on the capture THREAD, and a
            # render issued to the accelerator would queue behind whatever
            # the consumer is compiling or running there (a minute or more
            # for the pipeline's first batch), starving the stream until
            # clients time out. default_device at render time is not
            # enough — a scene built on the accelerator has committed
            # leaves that drag the op back to it — so pin the scene's
            # arrays to CPU here, on the constructing (main) thread.
            import jax
            cpu = jax.devices("cpu")[0]
            scene = jax.tree.map(
                lambda a: jax.device_put(a, cpu)
                if isinstance(a, jax.Array) else a, scene)
        self._scene = scene
        self._t = 0

    def read(self) -> np.ndarray:
        self._t += 1
        if self._scene is not None:
            import jax
            import jax.numpy as jnp

            from vision_basedsensor_tpu.synth import render_frames
            phase = 0.5 * (1 + np.sin(self._t / 20.0))
            d = np.zeros((1, 65, 3), np.float32)
            d[:, :, 2] = -phase
            with jax.default_device(jax.devices("cpu")[0]):
                f = np.asarray(render_frames(self._scene, jnp.asarray(d)))[0]
            return np.repeat(f[..., None], 3, -1).astype(np.uint8)
        img = np.zeros((self.cfg.height, self.cfg.width, 3), np.uint8)
        # Blocky "NO CAMERA" banner, drawable without cv2.
        img[self.cfg.height // 2 - 20:self.cfg.height // 2 + 20, 40:-40] = 96
        if _cv2 is not None:
            _cv2.putText(img, "NO CAMERA", (50, self.cfg.height // 2 + 8),
                         _cv2.FONT_HERSHEY_SIMPLEX, 1.5, (255, 255, 255), 3)
        return img


class CameraHandler:
    """Camera init (3 retries, MJPG fourcc) + background capture thread with
    a latest-frame mailbox (collecting.py:91-131 semantics)."""

    def __init__(self, cfg: CaptureConfig, leds: Optional[LedRing] = None,
                 synthetic: Optional[SyntheticCamera] = None):
        self.cfg = cfg
        self.leds = leds
        self.frame: Optional[bytes] = None  # latest JPEG (atomic replacement)
        self.running = True
        self._cap = None
        self._synthetic = synthetic or SyntheticCamera(cfg)
        if leds is not None:
            leds.all_white()  # light before opening, like collecting.py:93-95
        if synthetic is None:
            self._open_camera()

    def _open_camera(self) -> None:
        if _cv2 is None:
            return
        for _ in range(3):
            cap = _cv2.VideoCapture(self.cfg.camera_index, _cv2.CAP_V4L2)
            if cap.isOpened():
                cap.set(_cv2.CAP_PROP_FOURCC,
                        _cv2.VideoWriter_fourcc(*"MJPG"))
                cap.set(_cv2.CAP_PROP_FRAME_WIDTH, self.cfg.width)
                cap.set(_cv2.CAP_PROP_FRAME_HEIGHT, self.cfg.height)
                cap.set(_cv2.CAP_PROP_FPS, self.cfg.fps)
                self._cap = cap
                return
            time.sleep(0.2)

    def capture_loop(self) -> None:
        count = 0
        while self.running:
            if self._cap is not None:
                ok, frame = self._cap.read()
                if not ok:
                    time.sleep(0.05)
                    continue
            else:
                frame = self._synthetic.read()
                time.sleep(1.0 / max(1, self.cfg.fps))
            count += 1
            if count % (self.cfg.skip_frames + 1) != 0:
                continue
            self.frame = _encode_jpeg(frame, self.cfg.jpeg_quality)

    def get_frame(self) -> bytes:
        if self.frame is not None:
            return self.frame
        return _encode_jpeg(self._synthetic.read(), self.cfg.jpeg_quality)

    def close(self, capture_thread: "threading.Thread | None" = None) -> None:
        # cv2.VideoCapture is not thread-safe: release() racing a blocked
        # read() in the capture thread is undefined behavior (can segfault
        # the acquisition server on shutdown). Stop the loop, wait for the
        # thread to leave read() (a read blocks at most ~1/fps), THEN
        # release.
        self.running = False
        if capture_thread is not None and capture_thread.is_alive():
            capture_thread.join(timeout=2.0 + 1.0 / max(1, self.cfg.fps))
        if self._cap is not None:
            self._cap.release()


def _make_handler(camera: CameraHandler, cfg: CaptureConfig):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path == "/":
                body = (f"<html><body><img src='/stream' width='{cfg.width}'>"
                        f"<p>Camera Stream {cfg.width}x{cfg.height} @ "
                        f"{cfg.fps}fps</p></body></html>").encode()
                self.send_response(200)
                self.send_header("Content-type", "text/html")
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/stream":
                self.send_response(200)
                self.send_header(
                    "Content-type",
                    "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                try:
                    while camera.running:
                        jpeg = camera.get_frame()
                        self.wfile.write(
                            b"--frame\r\n"
                            b"Content-Type: image/jpeg\r\n"
                            b"Content-Length: "
                            + str(len(jpeg)).encode() + b"\r\n\r\n"
                            + jpeg + b"\r\n")
                        time.sleep(1.0 / max(1, cfg.fps))
                except (ConnectionError, BrokenPipeError):
                    pass
            elif self.path == "/snapshot":
                jpeg = camera.get_frame()
                self.send_response(200)
                self.send_header("Content-type", "image/jpeg")
                self.send_header("Content-length", str(len(jpeg)))
                self.end_headers()
                self.wfile.write(jpeg)
            else:
                self.send_error(404)

    return Handler


class StreamingServer:
    """Threaded MJPEG server wrapper with clean startup/shutdown."""

    def __init__(self, cfg: CaptureConfig, camera: CameraHandler):
        self.cfg = cfg
        self.camera = camera
        self._httpd = ThreadingHTTPServer(("0.0.0.0", cfg.port),
                                          _make_handler(camera, cfg))
        self.port = self._httpd.server_address[1]
        self._threads: list[threading.Thread] = []

    def start(self) -> None:
        t = threading.Thread(target=self.camera.capture_loop, daemon=True)
        t.start()
        s = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        s.start()
        self._threads = [t, s]

    def stop(self) -> None:
        cap_thread = self._threads[0] if self._threads else None
        self.camera.close(cap_thread)
        self._httpd.shutdown()
        self._httpd.server_close()


def run_server(cfg: CaptureConfig | None = None, synthetic: bool = False,
               block: bool = True) -> StreamingServer:
    """Bring up LEDs + camera + HTTP server (collecting.run_server analog)."""
    cfg = cfg or CaptureConfig()
    leds = LedRing(cfg)
    synth = None
    if synthetic:
        from vision_basedsensor_tpu.synth import default_scene
        synth = SyntheticCamera(cfg, default_scene(cfg.height, cfg.width))
    camera = CameraHandler(cfg, leds, synthetic=synth)
    server = StreamingServer(cfg, camera)
    server.start()
    print(f"Server started: http://0.0.0.0:{server.port}")
    if block:  # pragma: no cover
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            pass
        finally:
            server.stop()
            leds.off()
    return server
