"""The precision policy: every matmul whose result is rounded, thresholded
or fitted runs at ``Precision.HIGHEST``.

A float32 matmul on a GPU may otherwise run in TF32 (~3 decimal digits):
enough to flip threshold pixels of the DoG / NCC masks and to move the
plane fit the tilt is read from. The walk covers every ``dot_general`` in
the traced program, inside nested jits, scans and solves; the only ones
allowed another precision are the bf16-operand filter matmuls of the named
``DetectConfig.fast_filters`` path.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from vision_basedsensor_tpu.config import (DetectConfig, PipelineConfig,
                                           ReconstructConfig)
from vision_basedsensor_tpu.detect import detect_markers
from vision_basedsensor_tpu.pipeline import initialize, process_frames
from vision_basedsensor_tpu.synth import default_scene, render_frames

HIGHEST = jax.lax.Precision.HIGHEST


def dot_generals(jaxpr):
    """(precision, operand dtypes) of every dot_general, recursively."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append((eqn.params["precision"],
                          tuple(str(v.aval.dtype) for v in eqn.invars)))
        for sub in jax.core.jaxprs_in_params(eqn.params):
            found.extend(dot_generals(sub))
    return found


def _all_highest(found):
    return [f for f in found
            if f[0] is None or any(p != HIGHEST for p in f[0])]


@pytest.fixture(scope="module")
def small():
    cfg = PipelineConfig(reconstruct=ReconstructConfig(warmup_frames=0))
    scene = default_scene(240, 320)
    frames = render_frames(scene, jnp.zeros((2, 65, 3), jnp.float32))
    return cfg, scene, frames, initialize(frames[0], cfg)


@pytest.mark.parametrize("color", [False, True], ids=["gray", "bgr"])
def test_process_frames_matmuls_are_highest(small, color):
    cfg, scene, frames, ref = small
    if color:   # camera frames are BGR: the grayscale weighting is a dot
        frames = jnp.repeat(frames[..., None], 3, axis=-1)
    jpr = jax.make_jaxpr(
        lambda f, r: process_frames(f, r, scene.cam, cfg))(frames, ref)
    found = dot_generals(jpr.jaxpr)
    # Filters (8 banded matmuls), plane fits, rigid transforms.
    assert len(found) >= 10
    assert not _all_highest(found), _all_highest(found)


@pytest.mark.parametrize("profile", ["low_res", "high_res"])
def test_detect_markers_matmuls_are_highest(small, profile):
    _, _, frames, _ = small
    cfg = DetectConfig()
    jpr = jax.make_jaxpr(lambda f: detect_markers(
        f, cfg, profile=getattr(cfg, profile)))(frames)
    found = dot_generals(jpr.jaxpr)
    assert len(found) >= 8
    assert not _all_highest(found), _all_highest(found)


def test_fast_filters_is_the_only_exception(small):
    _, _, frames, _ = small
    cfg = dataclasses.replace(DetectConfig(), fast_filters=True)
    found = dot_generals(jax.make_jaxpr(
        lambda f: detect_markers(f, cfg))(frames).jaxpr)
    loose = _all_highest(found)
    assert loose, "fast_filters should run its filters in bf16"
    assert all("bfloat16" in dt for _, dts in loose for dt in dts), loose


def test_renderer_matmuls_are_highest():
    """The ground-truth renderer's ellipse shape matrices feed the marker
    images every accuracy test compares against."""
    scene = default_scene(240, 320)
    disp = jnp.zeros((2, 65, 3), jnp.float32)
    found = dot_generals(jax.make_jaxpr(
        lambda d: render_frames(scene, d))(disp).jaxpr)
    assert found
    assert not _all_highest(found), _all_highest(found)


def test_highest_filters_agree_with_float64_reference():
    """What the pin buys: the f32 banded-matmul blur agrees with a float64
    numpy convolution to ~1e-4 gray levels, far inside the 0.5 rounding
    step that ops/dog.py thresholds after."""
    from vision_basedsensor_tpu.core.imaging import gaussian_blur, gaussian_taps
    import scipy.ndimage as ndi

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (96, 128)).astype(np.float32)
    got = np.asarray(gaussian_blur(jnp.asarray(img), 21, 4.56))
    k = gaussian_taps(21, 4.56)
    want = ndi.correlate1d(ndi.correlate1d(img.astype(np.float64), k, 0,
                                           mode="mirror"), k, 1,
                           mode="mirror")
    assert np.abs(got - want).max() < 2e-3
