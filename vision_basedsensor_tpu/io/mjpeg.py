"""MJPEG-over-HTTP client: consume the acquisition server's stream directly.

In the reference the Pi streams MJPEG and an operator records an .avi by hand
for offline processing (SURVEY.md §1 stage 0->1). Here the stream is a
first-class live source: this client parses ``multipart/x-mixed-replace``
frames and feeds them straight into the batched device pipeline (see
``cli run-live``), closing the sensor -> host -> device loop in real time.
"""
from __future__ import annotations

import collections
import threading
import time
import urllib.request
from typing import Iterator

import numpy as np

from vision_basedsensor_tpu.utils.log import get_logger

_log = get_logger(__name__)

try:
    import cv2 as _cv2
except Exception:  # pragma: no cover
    _cv2 = None


def _decode_jpeg(buf: bytes) -> np.ndarray:
    if _cv2 is not None:
        img = _cv2.imdecode(np.frombuffer(buf, np.uint8), _cv2.IMREAD_COLOR)
        if img is not None:
            return img
    from io import BytesIO

    from PIL import Image
    return np.asarray(Image.open(BytesIO(buf)))[..., ::-1].copy()  # RGB->BGR


def sof_dims(jpeg: bytes) -> tuple[int, int] | None:
    """(width, height) from a JPEG's SOF header — a microsecond pure-Python
    marker scan. THE single scanner shared by the device decoder's per-batch
    geometry sniff (ops/jpeg.py) and ``cli record``'s AVI header sizing;
    handles APPn/DRI segments via the generic length skip and 0xFF fill
    bytes before markers (real cameras emit both)."""
    i, n = 2, len(jpeg)
    while i + 8 < n:
        if jpeg[i] != 0xFF:
            i += 1
            continue
        m = jpeg[i + 1]
        if m == 0xFF:           # fill-byte padding before a marker
            i += 1
            continue
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            i += 2
            continue
        if m == 0xDA:           # SOS: past the headers, no SOF found
            return None
        if m in (0xC0, 0xC1, 0xC2):
            h = (jpeg[i + 5] << 8) | jpeg[i + 6]
            w = (jpeg[i + 7] << 8) | jpeg[i + 8]
            return w, h
        i += 2 + ((jpeg[i + 2] << 8) | jpeg[i + 3])
    return None


def iter_mjpeg_bytes(url: str, boundary: bytes | None = None,
                     timeout: float = 10.0, max_frames: int | None = None
                     ) -> Iterator[bytes]:
    """Yield raw JPEG payloads from an MJPEG stream URL (no decode).

    The undecoded form feeds zero-transcode recording (``cli record`` writes
    the received JPEG bytes verbatim into an AVI container — the reference
    operator's record-to-avi step, ``collecting.py:177-191``, without
    spending the weak host's CPU on a decode+re-encode round trip).

    Parses the ``multipart/x-mixed-replace`` structure properly: the
    boundary comes from the Content-Type header (overridable), each part's
    headers are read, and the payload length comes from Content-Length when
    the server sends one (ours does) — scanning raw bytes for JPEG
    SOI/EOI magic would truncate frames whose EXIF/JFIF thumbnail embeds an
    inner EOI (real cameras do this; cv2.imencode doesn't).
    Without Content-Length the payload runs to the next boundary.
    """
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        if boundary is None:
            ctype = resp.headers.get("Content-Type", "")
            b = "frame"
            for piece in ctype.split(";"):
                piece = piece.strip()
                if piece.startswith("boundary="):
                    b = piece[len("boundary="):].strip('"')
            # RFC 2046: the delimiter is "--" + boundary param. Some IP
            # cameras nonconformingly include the leading dashes IN the
            # param; normalizing prevents searching for "----x" while the
            # stream delimits with "--x" (which would never match and grow
            # buf without bound).
            boundary = b"--" + b.lstrip("-").encode()

        buf = b""
        count = 0
        while max_frames is None or count < max_frames:
            chunk = resp.read(65536)
            if not chunk:
                break
            buf += chunk
            while True:
                start = buf.find(boundary)
                if start == -1:
                    break
                hdr_end = buf.find(b"\r\n\r\n", start)
                if hdr_end == -1:
                    break
                headers = buf[start + len(boundary):hdr_end]
                length = None
                for line in headers.split(b"\r\n"):
                    k, _, v = line.partition(b":")
                    if k.strip().lower() == b"content-length":
                        try:
                            length = int(v.strip())
                        except ValueError:
                            length = None
                payload_start = hdr_end + 4
                if length is not None:
                    if len(buf) < payload_start + length:
                        break  # need more bytes
                    frame_bytes = buf[payload_start:payload_start + length]
                    buf = buf[payload_start + length:]
                else:
                    nxt = buf.find(boundary, payload_start)
                    if nxt == -1:
                        break
                    frame_bytes = buf[payload_start:nxt].rstrip(b"\r\n")
                    buf = buf[nxt:]
                if not frame_bytes:
                    continue
                count += 1
                yield frame_bytes
                if max_frames is not None and count >= max_frames:
                    return


def iter_mjpeg(url: str, boundary: bytes | None = None,
               timeout: float = 10.0, max_frames: int | None = None
               ) -> Iterator[np.ndarray]:
    """Yield decoded BGR frames from an MJPEG stream URL (see
    :func:`iter_mjpeg_bytes` for the parsing contract)."""
    for frame_bytes in iter_mjpeg_bytes(url, boundary, timeout, max_frames):
        yield _decode_jpeg(frame_bytes)


class _StreamReader:
    """Background socket reader for live MJPEG sources.

    A live stream's socket must never be driven by the compute consumer:
    the pipeline's first-batch compile can take a minute or more, during
    which a directly-driven socket goes unread — the acquisition server's
    writer thread stalls on a full send buffer and the eventual client read
    times out. The reader thread drains the socket
    at stream rate into a bounded drop-oldest deque. These are also the
    right *serving* semantics for the closed robot loop (README.md:124
    pose compensation): a slow consumer sees the LATEST frames, never a
    growing stale backlog.
    """

    def __init__(self, url: str, max_frames: int | None, maxlen: int,
                 reconnects: int = 3):
        self._dq: collections.deque = collections.deque(maxlen=maxlen)
        self._cond = threading.Condition()
        self._done = False
        self._err: Exception | None = None
        self.dropped = 0
        self.reconnects = 0
        self._thread = threading.Thread(
            target=self._run, args=(url, max_frames, reconnects),
            daemon=True)
        self._thread.start()

    def _push(self, jb: bytes) -> None:
        with self._cond:
            if len(self._dq) == self._dq.maxlen:
                self.dropped += 1
            self._dq.append(jb)
            self._cond.notify()

    def _run(self, url: str, max_frames: int | None,
             reconnects: int) -> None:
        # Transient stream gaps (camera hiccup, wifi blip, server restart)
        # reconnect with backoff rather than killing the live session —
        # but only if the stream ever produced, so a wrong URL still
        # fails fast.
        count = 0
        try:
            while max_frames is None or count < max_frames:
                got_any = False
                try:
                    remaining = (None if max_frames is None
                                 else max_frames - count)
                    for jb in iter_mjpeg_bytes(url, max_frames=remaining):
                        got_any = True
                        count += 1
                        self._push(jb)
                    break  # clean end of stream
                except (TimeoutError, ConnectionError, OSError):
                    if not got_any or self.reconnects >= reconnects:
                        raise
                    self.reconnects += 1
                    _log.warning("live stream gap on %s — reconnecting "
                                 "(%d/%d)", url, self.reconnects, reconnects)
                    time.sleep(0.5 * self.reconnects)
        except Exception as e:  # surfaced to the consumer, not swallowed
            self._err = e
        finally:
            with self._cond:
                self._done = True
                self._cond.notify_all()
            if self.dropped:
                _log.info("live stream ended: %d frame(s) dropped to stay "
                          "current (consumer slower than stream)",
                          self.dropped)

    def frames(self) -> Iterator[bytes]:
        while True:
            with self._cond:
                while not self._dq and not self._done:
                    self._cond.wait(0.5)
                if self._dq:
                    jb = self._dq.popleft()
                elif self._done:
                    if self._err is not None:
                        raise self._err
                    return
                else:  # pragma: no cover - spurious wake
                    continue
            yield jb


class MjpegVideoSource:
    """VideoSource adapter over a live MJPEG stream.

    The socket is drained by a :class:`_StreamReader` thread; the consumer
    gets drop-oldest latest-frame semantics (``last_dropped`` counts what
    a slow consumer skipped over the life of the last ``batches`` run).
    """

    def __init__(self, url: str, fps: float = 12.0,
                 max_frames: int | None = None):
        self.url = url
        self._fps = fps
        self._max = max_frames
        self.last_dropped = 0

    @property
    def fps(self) -> float:
        return self._fps

    def batches(self, batch_size: int):
        reader = _StreamReader(self.url, self._max,
                               maxlen=max(2 * batch_size, 8))
        buf = []
        for jb in reader.frames():
            buf.append(_decode_jpeg(jb))
            if len(buf) == batch_size:
                yield np.stack(buf)
                buf = []
            self.last_dropped = reader.dropped
        self.last_dropped = reader.dropped
        if buf:
            yield np.stack(buf)


class MjpegDeviceVideoSource:
    """Live MJPEG stream decoded ON the device (sparse coefficient transport).

    The streaming analog of :class:`io.video.MjpegAviDeviceSource` — the
    host does only the native Huffman entropy decode per received JPEG; a
    few bytes per nonzero DCT coefficient go to the device (vs the full raw
    frame) and dequant+IDCT run as batched matmuls (ops/jpeg.py). The
    robot-side `run-live --device-decode` loop (README.md:124's pose
    compensation) never pays a host IDCT.

    Yields committed DEVICE float32 gray batches. Raises at construction
    when the native decoder can't be built — callers fall back to
    :class:`MjpegVideoSource`.
    """

    def __init__(self, url: str, fps: float = 12.0,
                 max_frames: int | None = None, transport: str = "tdelta",
                 zmax: int = 64):
        """``transport``: ``tdelta`` (default — temporal coefficient
        deltas, the fewest link bytes on the production slow-scene
        workload), ``split`` (scene-independent), or ``packed`` — see
        :class:`~...ops.jpeg.MjpegBatchDecoder`. ``zmax`` (split/tdelta):
        zigzag band limit; 64 = exact, lower = the detect-grade profile
        (ops/jpeg.py header)."""
        from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
        if transport not in ("tdelta", "split", "packed"):
            raise ValueError(
                f"transport must be tdelta|split|packed, got {transport}")
        if zmax != 64 and transport not in ("split", "tdelta"):
            raise ValueError(
                "zmax band limit requires transport='split'|'tdelta'")
        self.url = url
        self._fps = fps
        self._max = max_frames
        self._dec = MjpegBatchDecoder()
        self._transport = transport
        self._zmax = zmax
        self.last_dropped = 0
        self.session_stats: dict | None = None

    @property
    def fps(self) -> float:
        return self._fps

    @property
    def last_stats(self) -> dict | None:
        """Byte accounting ACCUMULATED over the whole session (not just the
        most recent batch — a tail flush batch's sparsity is not the
        stream's; the CLI prints this as the per-frame link cost)."""
        return self.session_stats

    def _account(self, st: dict | None) -> None:
        if st:
            if self.session_stats is None:
                self.session_stats = dict(st)
            else:
                for key in ("frames", "nnz", "bytes_shipped", "bytes_dense"):
                    if key in st:
                        self.session_stats[key] = (self.session_stats.get(key, 0)
                                                   + st[key])

    def _decode(self, buf):
        return self.to_device(self._entropy(buf))

    def _entropy(self, buf):
        if self._transport == "tdelta":
            hp = self._dec.entropy_decode_tdelta(buf, zmax=self._zmax)
        elif self._transport == "split":
            hp = self._dec.entropy_decode_split(buf, zmax=self._zmax)
        else:
            hp = self._dec.entropy_decode_packed(buf)
        self._account(hp.stats)
        return hp

    def to_device(self, payload):
        """Device half of the two-thread feed (jit dispatch) — call it on
        the consumer thread, so all device work is issued from one thread
        (io/video.device_feed)."""
        return {"tdelta": self._dec.tdelta_to_device,
                "split": self._dec.split_to_device,
                "packed": self._dec.packed_to_device}[self._transport](payload)

    def batches(self, batch_size: int):
        reader = _StreamReader(self.url, self._max,
                               maxlen=max(2 * batch_size, 8))
        buf = []
        for jb in reader.frames():
            buf.append(jb)
            if len(buf) == batch_size:
                yield self._decode(buf)
                buf = []
            self.last_dropped = reader.dropped
        self.last_dropped = reader.dropped
        if buf:
            yield self._decode(buf)

    def host_batches(self, batch_size: int):
        """Host-only half of :meth:`batches` (native entropy decode, no jax
        dispatch) — what device_feed's prefetch thread drives; it calls
        :meth:`to_device` on the consumer thread."""
        reader = _StreamReader(self.url, self._max,
                               maxlen=max(2 * batch_size, 8))
        buf = []
        for jb in reader.frames():
            buf.append(jb)
            if len(buf) == batch_size:
                yield self._entropy(buf)
                buf = []
            self.last_dropped = reader.dropped
        self.last_dropped = reader.dropped
        if buf:
            yield self._entropy(buf)
