"""Video sources and sinks + double-buffered device feed.

Host shell around the device pipeline (SURVEY.md §7 layer 7): decode happens on
host (OpenCV when available), frames move to device in batches with a
one-batch lookahead so decode overlaps compute — the transport analog of the
reference's capture thread + latest-frame mailbox (``collecting.py:111-131``).

Sources are gated on their dependencies: ``FileVideoSource`` needs cv2;
``ArrayVideoSource`` (npy/npz stacks) and ``SyntheticVideoSource`` (rendered
dome scenes) are always available and serve as the fake-camera test backbone
(the analog of the reference's "NO CAMERA" synthetic frames,
``collecting.py:133-142``).
"""
from __future__ import annotations

import functools
import threading
from typing import Iterator

import numpy as np

try:  # optional host dependency
    import cv2 as _cv2
except Exception:  # pragma: no cover
    _cv2 = None


class VideoSource:
    """Iterator of frame batches ``(B, H, W)`` or ``(B, H, W, 3)`` uint8."""

    def batches(self, batch_size: int) -> Iterator[np.ndarray]:
        raise NotImplementedError

    @property
    def fps(self) -> float:
        return 0.0


class ArrayVideoSource(VideoSource):
    """Frames from an in-memory array or .npy/.npz file."""

    def __init__(self, frames_or_path, fps: float = 12.0):
        if isinstance(frames_or_path, str):
            if frames_or_path.endswith(".npz"):
                with np.load(frames_or_path) as z:
                    frames = z[list(z.keys())[0]]
            else:
                frames = np.load(frames_or_path)
        else:
            frames = np.asarray(frames_or_path)
        self._frames = frames
        self._fps = fps

    @property
    def fps(self) -> float:
        return self._fps

    def batches(self, batch_size: int) -> Iterator[np.ndarray]:
        for i in range(0, len(self._frames), batch_size):
            yield self._frames[i:i + batch_size]


class FileVideoSource(VideoSource):
    """Decode a video file via OpenCV (reference input path,
    ``marker_detection.py:52``)."""

    def __init__(self, path: str):
        if _cv2 is None:
            raise RuntimeError("FileVideoSource requires cv2 (opencv-python)")
        self._cap = _cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise IOError(f"Could not open video: {path}")
        self._fps = self._cap.get(_cv2.CAP_PROP_FPS)

    @property
    def fps(self) -> float:
        return self._fps

    def batches(self, batch_size: int) -> Iterator[np.ndarray]:
        buf = []
        while True:
            ok, frame = self._cap.read()
            if not ok:
                break
            buf.append(frame)
            if len(buf) == batch_size:
                yield np.stack(buf)
                buf = []
        if buf:
            yield np.stack(buf)
        self._cap.release()


class SyntheticVideoSource(VideoSource):
    """Rendered dome frames for a prescribed displacement sequence."""

    def __init__(self, scene, displacements, fps: float = 12.0):
        self._scene = scene
        self._disp = np.asarray(displacements)
        self._fps = fps

    @property
    def fps(self) -> float:
        return self._fps

    def batches(self, batch_size: int) -> Iterator[np.ndarray]:
        from vision_basedsensor_tpu.synth import render_frames
        import jax.numpy as jnp
        for i in range(0, len(self._disp), batch_size):
            chunk = jnp.asarray(self._disp[i:i + batch_size], jnp.float32)
            yield np.asarray(render_frames(self._scene, chunk)).astype(np.uint8)


def _iter_avi_video_chunks(buf: bytes):
    """Yield raw stream-0 video frame payloads from an AVI byte buffer.

    Minimal RIFF walk of the 'movi' list: chunks are fourcc + LE32 size +
    data (padded to even); video frames are '..dc'/'..db' chunks; 'rec '
    LISTs are descended into; 'idx1' ends the stream. Enough structure for
    the MJPG files our capture stack and cv2's MJPG writer produce.
    """
    i = buf.find(b"movi")
    if i < 0:
        raise ValueError("no 'movi' list found (not an AVI?)")
    pos = i + 4
    end = len(buf)
    while pos + 8 <= end:
        cc = buf[pos:pos + 4]
        size = int.from_bytes(buf[pos + 4:pos + 8], "little")
        if cc == b"idx1":
            return
        if cc == b"LIST":
            pos += 12  # descend (skip the list-type fourcc)
            continue
        if cc[2:4] in (b"dc", b"db") and size > 0:
            yield buf[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)


class MjpegAviSource(VideoSource):
    """Parallel-decode source for MJPG-encoded ``.avi`` files.

    ``FileVideoSource`` (cv2.VideoCapture) decodes strictly sequentially —
    the host-side wall for the >=1000 fps pipeline. Motion-JPEG frames are
    independent, so this source demuxes the AVI itself (RIFF chunk walk) and
    decodes JPEGs on a thread pool (cv2.imdecode releases the GIL), scaling
    decode with host cores. MJPEG is also what the acquisition stack streams
    (``collecting.py:130``), so recordings of the real sensor take this path.
    """

    def __init__(self, path: str, workers: int | None = None,
                 gray: bool = False, fps: float = 12.0):
        import os
        with open(path, "rb") as f:
            self._buf = f.read()
        first = next(_iter_avi_video_chunks(self._buf), None)
        if first is None or not first.startswith(b"\xff\xd8"):
            raise ValueError(f"{path}: not an MJPEG AVI (use FileVideoSource)")
        self._workers = workers or min(32, (os.cpu_count() or 4))
        self._gray = gray
        self._fps = fps

    @property
    def fps(self) -> float:
        return self._fps

    def num_frames(self) -> int:
        return sum(1 for _ in _iter_avi_video_chunks(self._buf))

    def batches(self, batch_size: int) -> Iterator[np.ndarray]:
        from concurrent.futures import ThreadPoolExecutor

        flag = 0 if self._gray else 1  # IMREAD_GRAYSCALE / IMREAD_COLOR
        if _cv2 is not None:
            def dec(chunk: bytes) -> np.ndarray:
                return _cv2.imdecode(np.frombuffer(chunk, np.uint8), flag)
        else:  # pragma: no cover
            def dec(chunk: bytes) -> np.ndarray:
                from io import BytesIO

                from PIL import Image
                img = Image.open(BytesIO(chunk))
                if self._gray:
                    return np.asarray(img.convert("L"))
                return np.asarray(img.convert("RGB"))[..., ::-1].copy()

        # Lazy submission with a bounded lookahead (2 batches): Executor.map
        # would submit every frame up front, so an abandoned generator (or a
        # slow consumer) keeps burning CPU on frames nobody will read.
        from collections import deque
        from itertools import islice

        chunks = iter(_iter_avi_video_chunks(self._buf))
        buf = []
        with ThreadPoolExecutor(self._workers) as ex:
            pending = deque(ex.submit(dec, c)
                            for c in islice(chunks, 2 * batch_size))
            while pending:
                frame = pending.popleft().result()
                nxt = next(chunks, None)
                if nxt is not None:
                    pending.append(ex.submit(dec, nxt))
                buf.append(frame)
                if len(buf) == batch_size:
                    yield np.stack(buf)
                    buf = []
        if buf:
            yield np.stack(buf)


class MjpegAviDeviceSource(VideoSource):
    """MJPEG ``.avi`` -> gray frames decoded ON the device.

    The only host work per frame is the native C++ Huffman entropy decode
    (ops/jpeg.py, native/jpeg_coeffs.cpp); dequantization + the 8x8 IDCT +
    reassembly run as batched matmuls on device. ``batches`` yields
    committed DEVICE float32 arrays, and the IDCT FLOPs leave the host.

    Raises at construction when the native decoder can't be built — fall
    back to :class:`MjpegAviSource`.
    """

    def __init__(self, path: str, fps: float = 12.0,
                 transport: str = "tdelta", zmax: int = 64):
        """``transport``: ``tdelta`` (default — temporal coefficient
        deltas, ~3 KB/frame at 480p q70 on the production slow-scene
        workload, degrading boundedly to ~2x ``split`` on noise),
        ``split`` (DC/AC-separated VLC streams, ~22 KB/frame, the
        scene-independent choice), ``packed`` (2-byte delta pairs), or
        ``dense`` (full coefficient tensor, the ablation). ``zmax``
        (split/tdelta, 2..64): zigzag band limit — 64 decodes exactly;
        lower values are the opt-in tracking-grade profile (ops/jpeg.py
        header) at a further large byte cut."""
        from vision_basedsensor_tpu.ops.jpeg import MjpegBatchDecoder
        if transport not in ("tdelta", "split", "packed", "dense"):
            raise ValueError(f"transport must be tdelta|split|packed|dense, "
                             f"got {transport}")
        if zmax != 64 and transport not in ("split", "tdelta"):
            raise ValueError(
                "zmax band limit requires transport='split'|'tdelta'")
        with open(path, "rb") as f:
            self._buf = f.read()
        first = next(_iter_avi_video_chunks(self._buf), None)
        if first is None or not first.startswith(b"\xff\xd8"):
            raise ValueError(f"{path}: not an MJPEG AVI")
        self._dec = MjpegBatchDecoder()
        self._transport = transport
        self._zmax = zmax
        self._fps = fps

    @property
    def fps(self) -> float:
        return self._fps

    @property
    def last_stats(self) -> dict | None:
        """Byte accounting of the most recent batch (ops/jpeg.py)."""
        return self._dec.last_stats

    def batches(self, batch_size: int):
        if self._transport in ("split", "tdelta"):
            dec = functools.partial(
                {"split": self._dec.decode_split,
                 "tdelta": self._dec.decode_tdelta}[self._transport],
                zmax=self._zmax)
        else:
            dec = {"packed": self._dec.decode_packed,
                   "dense": self._dec.decode}[self._transport]
        chunks = []
        for c in _iter_avi_video_chunks(self._buf):
            chunks.append(c)
            if len(chunks) == batch_size:
                yield dec(chunks)
                chunks = []
        if chunks:
            yield dec(chunks)

    def host_batches(self, batch_size: int):
        """Host-only half of :meth:`batches`: native entropy decode to
        numpy payloads, NO jax dispatch — safe to drive from device_feed's
        prefetch thread. Pair with :meth:`to_device`."""
        if self._transport in ("split", "tdelta"):
            dec = functools.partial(
                {"split": self._dec.entropy_decode_split,
                 "tdelta": self._dec.entropy_decode_tdelta}[self._transport],
                zmax=self._zmax)
        else:
            dec = {"packed": self._dec.entropy_decode_packed,
                   "dense": self._dec.entropy_decode_dense}[self._transport]
        chunks = []
        for c in _iter_avi_video_chunks(self._buf):
            chunks.append(c)
            if len(chunks) == batch_size:
                yield dec(chunks)
                chunks = []
        if chunks:
            yield dec(chunks)

    def to_device(self, payload):
        """Device half of the two-thread feed — call on the MAIN thread."""
        return {"tdelta": self._dec.tdelta_to_device,
                "split": self._dec.split_to_device,
                "packed": self._dec.packed_to_device,
                "dense": self._dec.dense_to_device}[self._transport](payload)


class MjpegAviWriter:
    """Mux raw JPEG frames into an MJPG ``.avi`` WITHOUT transcoding.

    The reference's operator records the Pi's MJPEG stream to ``.avi`` for
    offline processing (``collecting.py:177-191``, SURVEY.md §1 stage 0->1).
    A decode + re-encode round trip per frame is exactly what the weak
    acquisition-side hosts cannot afford, and it recompresses the frames —
    this writer instead wraps the received JPEG payloads verbatim in a
    minimal RIFF/AVI container (avih + one MJPG 'vids' stream + movi +
    idx1). Everything that reads MJPG AVIs (cv2, ffmpeg, MjpegAviSource's
    RIFF walk) accepts the output; the stored bytes are bit-identical to
    what the camera sent. No cv2 dependency.
    """

    def __init__(self, path: str, fps: float, size_wh: tuple[int, int]):
        import struct
        self._struct = struct
        self._f = open(path, "wb")
        self._fps = float(fps)
        self._w, self._h = size_wh
        self._sizes: list[int] = []
        w = self._f.write
        p = struct.pack
        w(b"RIFF" + p("<I", 0) + b"AVI ")                    # size patched
        # hdrl list: avih + strl(strh, strf)
        avih = p("<IIIIIIIIII4I",
                 int(1e6 / self._fps), 0, 0, 0x10,           # usec/frame, HASINDEX
                 0, 0, 1, 0, self._w, self._h, 0, 0, 0, 0)   # frames patched
        strh = (b"vids" + b"MJPG" + p("<IHHIIIIIIII", 0, 0, 0, 0,
                                      1000, int(self._fps * 1000),  # scale/rate
                                      0, 0, 0, 0xFFFFFFFF, 0)
                + p("<4H", 0, 0, self._w, self._h))
        strf = p("<IiiHH4sIiiII", 40, self._w, self._h, 1, 24, b"MJPG",
                 self._w * self._h * 3, 0, 0, 0, 0)
        strl = (b"LIST" + p("<I", 4 + 8 + len(strh) + 8 + len(strf))
                + b"strl" + b"strh" + p("<I", len(strh)) + strh
                + b"strf" + p("<I", len(strf)) + strf)
        hdrl = (b"LIST"
                + p("<I", 4 + 8 + len(avih) + len(strl))
                + b"hdrl" + b"avih" + p("<I", len(avih)) + avih + strl)
        self._avih_frames_pos = self._f.tell() + 8 + 4 + 8 + 16
        self._strh_length_pos = (self._f.tell() + 8 + 4 + 8 + len(avih)
                                 + 8 + 4 + 8 + 32)
        w(hdrl)
        self._movi_pos = self._f.tell()
        w(b"LIST" + p("<I", 0) + b"movi")                    # size patched

    def write_jpeg(self, data: bytes) -> None:
        w = self._f.write
        w(b"00dc" + self._struct.pack("<I", len(data)) + data)
        if len(data) & 1:
            w(b"\x00")
        self._sizes.append(len(data))

    def close(self) -> None:
        p = self._struct.pack
        f = self._f
        movi_end = f.tell()
        # idx1: one keyframe entry per chunk; offsets relative to 'movi'+4.
        f.write(b"idx1" + p("<I", 16 * len(self._sizes)))
        off = 4
        for sz in self._sizes:
            f.write(b"00dc" + p("<II", 0x10, off) + p("<I", sz))
            off += 8 + sz + (sz & 1)
        end = f.tell()
        n = len(self._sizes)
        f.seek(4)
        f.write(p("<I", end - 8))                            # RIFF size
        f.seek(self._avih_frames_pos)
        f.write(p("<I", n))                                  # dwTotalFrames
        f.seek(self._strh_length_pos)
        f.write(p("<I", n))                                  # strh dwLength
        f.seek(self._movi_pos + 4)
        f.write(p("<I", movi_end - self._movi_pos - 8))      # movi LIST size
        f.close()

    @property
    def frames_written(self) -> int:
        return len(self._sizes)


class VideoWriter:
    """Annotated-video sink (XVID .avi like ``marker_detection.py:70-76``;
    pass ``fourcc='MJPG'`` for Motion-JPEG). No-op when cv2 is absent."""

    def __init__(self, path: str, fps: float, size_wh: tuple[int, int],
                 fourcc: str = "XVID"):
        self._writer = None
        if _cv2 is not None:
            four = _cv2.VideoWriter_fourcc(*fourcc)
            self._writer = _cv2.VideoWriter(path, four, fps, size_wh)

    def write(self, frame: np.ndarray) -> None:
        if self._writer is not None:
            if frame.ndim == 2:
                frame = np.repeat(frame[..., None], 3, axis=-1)
            self._writer.write(frame.astype(np.uint8))

    def close(self) -> None:
        if self._writer is not None:
            self._writer.release()


def device_feed(source: VideoSource, batch_size: int,
                device=None) -> Iterator:
    """Double-buffered host->device frame feed.

    Decodes batch k+1 on a host thread while batch k is on device — the
    host-side half of the >=1000 fps pipeline (SURVEY.md §7 "hard parts").
    Yields committed device arrays.

    Sources that decode ON the device (MjpegAviDeviceSource,
    MjpegDeviceVideoSource) expose a split API: ``host_batches`` runs only
    the native entropy decode (prefetch-thread safe) and ``to_device``
    issues the jit dispatch here on the consumer thread, so every device
    operation of the feed is issued from one thread.
    """
    import jax

    to_dev = getattr(source, "to_device", None)
    it = (source.host_batches(batch_size) if to_dev is not None
          else source.batches(batch_size))
    lock = threading.Lock()
    state: dict = {}

    def prefetch():
        # Errors must cross the thread boundary: a decode failure that only
        # kills the prefetch thread would leave the previous batch in
        # state["next"], making the consumer yield it TWICE and end the
        # stream cleanly — silent double-processing instead of an error.
        try:
            nxt, err = next(it), None
        except StopIteration:
            nxt, err = None, None
        except BaseException as e:  # noqa: BLE001 - re-raised in consumer
            nxt, err = None, e
        with lock:
            state["next"] = nxt
            state["err"] = err

    t = threading.Thread(target=prefetch)
    t.start()
    # One-batch DEVICE lookahead on top of the host prefetch: batch k+1's
    # transfer + expand dispatch is issued (async) BEFORE batch k is
    # yielded, so the link and the expand pipeline under the consumer's
    # compute instead of serializing with it. All jax dispatch stays on
    # this (the consumer's) thread; only the host decode runs on the
    # prefetch thread. The host payloads are defensive copies
    # (ops/jpeg.py), so the in-flight transfer cannot race the next
    # decode reusing the decoder's persistent buffers.
    pending = None
    while True:
        t.join()
        with lock:
            batch = state.get("next")
            err = state.get("err")
        if err is not None:
            # The batch decoded BEFORE the failure is valid work — deliver
            # it, then surface the error (each batch exactly once).
            if pending is not None:
                yield pending
            raise err
        if batch is None:
            if pending is not None:
                yield pending
            return
        t = threading.Thread(target=prefetch)
        t.start()
        arr = (to_dev(batch) if to_dev is not None
               else jax.device_put(batch, device))
        if pending is not None:
            yield pending
        pending = arr
