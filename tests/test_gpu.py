"""Tests that need a card (``gpu_only``): the plain-XLA path compiled for
the GPU against the CPU backend and the synthetic ground truth. Run them
on a machine with a GPU:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu_only tests/

Without a GPU the ``gpu_device`` fixture skips them.
"""
import jax
import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu_only


def test_detect_and_pipeline_match_cpu_on_gpu(gpu_device):
    cs.phase_card_vs_cpu(((480, 640, 4), (968, 1280, 1)), card=gpu_device,
                         cpu=jax.devices("cpu")[0])


def test_process_frames_tracks_ground_truth_on_gpu(gpu_device):
    with jax.default_device(gpu_device):
        r = cs.phase_compile([(480, 640, 64)], run_shape=(480, 640, 64),
                             iters=1)
    assert r["min_tracked"] == 65
