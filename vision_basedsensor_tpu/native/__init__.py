"""Native (C++) host-side components, loaded via ctypes.

The accelerator is the compute engine; the runtime around it stays native
where the work is genuinely serial and branchy. Currently: the baseline-JPEG
entropy decoder (jpeg_coeffs.cpp) that feeds the device JPEG decode path
(ops/jpeg.py).

Build model: compiled on first use with the system C++ compiler into the
user cache directory (the package tree may be read-only), then dlopened.
No pybind11 — plain C ABI + ctypes. Environments without a compiler simply
get ``None`` from :func:`load_jpeg_lib` and callers fall back to host decode.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "jpeg_coeffs.cpp")
_lock = threading.Lock()
_cached: dict[str, object] = {}


def _cache_dir() -> str:
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    d = os.path.join(base, "vision_basedsensor_tpu")
    os.makedirs(d, exist_ok=True)
    return d


def _build(src: str) -> str | None:
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_cache_dir(), f"libvbsjpeg_{tag}.so")
    if os.path.exists(out):
        return out
    for cxx in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if not cxx:
            continue
        tmp = out + f".tmp{os.getpid()}"
        cmd = [cxx, "-O3", "-fPIC", "-shared", "-std=c++17", "-pthread",
               src, "-o", tmp]
        try:
            r = subprocess.run(cmd, capture_output=True, timeout=120)
        except Exception:
            continue
        if r.returncode == 0:
            os.replace(tmp, out)
            return out
        print(f"[native] {cxx} failed: {r.stderr.decode()[:500]}",
              file=sys.stderr)
    return None


def load_jpeg_lib():
    """Compile (once) and load the JPEG entropy decoder; None if no compiler."""
    with _lock:
        if "jpeg" in _cached:
            return _cached["jpeg"]
        lib = None
        try:
            path = _build(_SRC)
            if path is not None:
                lib = ctypes.CDLL(path)
                lib.vbs_jpeg_y_coeffs.restype = ctypes.c_int
                lib.vbs_jpeg_y_coeffs.argtypes = [
                    ctypes.c_char_p, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int16), ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_uint16),
                ]
                lib.vbs_mjpeg_batch_y_coeffs.restype = ctypes.c_int
                lib.vbs_mjpeg_batch_y_coeffs.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int16), ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_uint16),
                ]
                lib.vbs_mjpeg_batch_y_coeffs_delta.restype = ctypes.c_int
                lib.vbs_mjpeg_batch_y_coeffs_delta.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(ctypes.c_int16), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_uint16),
                ]
                lib.vbs_mjpeg_batch_y_coeffs_delta_mt.restype = ctypes.c_int
                lib.vbs_mjpeg_batch_y_coeffs_delta_mt.argtypes = (
                    lib.vbs_mjpeg_batch_y_coeffs_delta.argtypes
                    + [ctypes.c_int])
                lib.vbs_mjpeg_batch_y_coeffs_split.restype = ctypes.c_int
                lib.vbs_mjpeg_batch_y_coeffs_split.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_uint8),  # DC nibble lane
                    ctypes.POINTER(ctypes.c_uint16),
                    ctypes.POINTER(ctypes.c_int16), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_uint16),
                    ctypes.POINTER(ctypes.c_int16), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_uint16),
                    ctypes.c_int,  # zmax (band limit; 64 = lossless)
                ]
                lib.vbs_mjpeg_batch_y_coeffs_split_mt.restype = ctypes.c_int
                lib.vbs_mjpeg_batch_y_coeffs_split_mt.argtypes = (
                    lib.vbs_mjpeg_batch_y_coeffs_split.argtypes
                    + [ctypes.c_int])
                lib.vbs_mjpeg_batch_y_coeffs_tdelta.restype = ctypes.c_int
                lib.vbs_mjpeg_batch_y_coeffs_tdelta.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_uint16),
                    ctypes.POINTER(ctypes.c_int16), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_uint16),
                    ctypes.c_int,  # zmax (band limit; 64 = lossless)
                ]
                lib.vbs_mjpeg_batch_y_coeffs_tdelta_mt.restype = ctypes.c_int
                lib.vbs_mjpeg_batch_y_coeffs_tdelta_mt.argtypes = (
                    lib.vbs_mjpeg_batch_y_coeffs_tdelta.argtypes
                    + [ctypes.c_int])
        except Exception as e:  # pragma: no cover
            print(f"[native] jpeg lib unavailable: {e}", file=sys.stderr)
            lib = None
        _cached["jpeg"] = lib
        return lib
