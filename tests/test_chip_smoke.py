"""chip_smoke.py and bench.py without a card: both refuse to produce a
result, and chip_smoke.py's phases run end to end on the CPU at small
sizes (the same code the card runs at full size)."""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

import chip_smoke as cs
from mjpeg_fixture import FIXTURE, N_FRAMES, fixture_frames  # test-local

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_without_gpu_fails_without_result():
    r = _run(["chip_smoke.py"], ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "needs a GPU" in r.stderr


def test_bench_without_gpu_fails_without_result():
    r = _run(["bench.py"], ROOT)
    assert r.returncode != 0
    assert '"value"' not in r.stdout and "no GPU" in r.stderr


def test_tilt_ramp_truth_is_the_fitted_tilt():
    from vision_basedsensor_tpu import layout
    from vision_basedsensor_tpu.core.fit import fit_plane

    disp, truth = cs.tilt_ramp(5, 960)
    table = layout.dome_layout()[:, 1:]
    start = np.stack([table[:, 0], table[:, 1], np.zeros(65)], -1)
    fit = fit_plane(jax.numpy.asarray(start[None] + disp))
    np.testing.assert_allclose(np.asarray(fit.tilt_deg), truth, atol=1e-3)
    assert truth[0] == 0.0 and 4.0 < truth[-1] < 5.5


def test_host_decode_matches_libjpeg():
    cv2 = pytest.importorskip("cv2")
    jpegs = cs.avi_jpegs(FIXTURE)[:4]
    got = cs.host_decode(jpegs).astype(np.int16)
    want = np.stack([cv2.imdecode(np.frombuffer(j, np.uint8),
                                  cv2.IMREAD_GRAYSCALE) for j in jpegs])
    assert np.abs(got - want).max() <= 1


def test_fixture_is_the_recipe_at_q70():
    jpegs = cs.avi_jpegs(FIXTURE)
    assert len(jpegs) == N_FRAMES
    decoded = cs.host_decode(jpegs).astype(np.float32)
    assert decoded.shape == (N_FRAMES, 480, 640)
    # q70 quantization: ~1.5 gray levels mean error on this scene.
    err = np.abs(decoded - fixture_frames().astype(np.float32))
    assert err.mean() < 2.5 and err.max() < 64


def test_phase_compile_runs_on_cpu():
    r = cs.phase_compile([(480, 640, 2)], run_shape=(480, 640, 2), iters=1)
    assert r["min_tracked"] == 65 and r["max_centroid_err_px"] < cs.TOL_480[0]


def test_phase_replay_runs_on_cpu(tmp_path):
    r = cs.phase_replay(str(tmp_path), 480, 640, frames_per_step=1,
                        highres=())
    assert r["indent"]["step_err_mm"] < cs.STEP_TOL_MM


def test_phase_device_decode_runs_on_cpu(tmp_path):
    from vision_basedsensor_tpu.native import load_jpeg_lib
    if load_jpeg_lib() is None:
        pytest.skip("no C++ compiler for the native JPEG decoder")
    r = cs.phase_device_decode(str(tmp_path), n_frames=4, batch=2,
                               live_frames=4)
    assert r["live_batches"] >= 1 and r["state"]["frames_seen"] >= 2


def test_phase_device_decode_fails_on_host_fallback(tmp_path, monkeypatch):
    """A ``track --device-decode`` that falls back to host decode must not
    pass for a device decode."""
    from vision_basedsensor_tpu.io import video
    from vision_basedsensor_tpu.native import load_jpeg_lib
    if load_jpeg_lib() is None:
        pytest.skip("no C++ compiler for the native JPEG decoder")
    real, calls = video.MjpegAviDeviceSource, []

    def first_call_only(*a, **k):
        # The phase's own pixel check builds the first source; the second
        # is the one ``track --device-decode`` asks for.
        calls.append(a)
        if len(calls) > 1:
            raise RuntimeError("no device decode")
        return real(*a, **k)

    monkeypatch.setattr(video, "MjpegAviDeviceSource", first_call_only)
    with pytest.raises(AssertionError, match="did not decode on the device"):
        cs.phase_device_decode(str(tmp_path), n_frames=2, batch=2)


def test_phase_card_vs_cpu_runs_on_cpu():
    worst = cs.phase_card_vs_cpu(((240, 320, 1),), card=jax.devices()[0])
    assert worst == {k: 0.0 for k in cs.CARD_CPU_TOL}


def test_phase_four_cards_runs_on_cpu_mesh():
    from vision_basedsensor_tpu.native import load_jpeg_lib
    if load_jpeg_lib() is None:
        pytest.skip("no C++ compiler for the native JPEG decoder")
    r = cs.phase_four_cards(jax.devices()[:4], 480, 640, 4)
    assert r["data=4"] <= 1e-3 and r["data=2xspatial=2"] <= 1e-3
