"""Utilities: stage timer, trace annotation, loggers, config round-trip."""
import logging
import os

import jax.numpy as jnp

from vision_basedsensor_tpu.config import (
    DetectConfig,
    PipelineConfig,
    TrackConfig,
    from_json,
    to_json,
)
from vision_basedsensor_tpu.utils import StageTimer, get_logger, trace_annotation


def test_stage_timer_accounts_blocking():
    t = StageTimer()
    x = jnp.arange(1024.0)
    with t.stage("square", block_on=None):
        y = x * x
    with t.stage("square", block_on=y):
        y = y + 1
    assert t.counts["square"] == 2
    assert t.totals["square"] > 0
    assert "square" in t.report()


def test_trace_annotation_noop():
    with trace_annotation("unit-test"):
        pass  # must not raise with or without an active profiler


def test_get_logger_file_handler(tmp_path):
    log = get_logger("unit", logfile=str(tmp_path / "sub" / "x.log"))
    log.info("hello")
    for h in log.handlers:
        h.flush()
    assert os.path.exists(tmp_path / "sub" / "x.log")


def test_config_json_roundtrip(tmp_path):
    cfg = PipelineConfig(
        detect=DetectConfig(max_candidates=80, centroid_mode="band"),
        track=TrackConfig(min_marker_distance_px=25.0, ring_method="kmeans"),
        crop_ratios=(0.1, 0.1, 0.0, 0.0),
    )
    p = str(tmp_path / "cfg.json")
    to_json(cfg, p)
    back = from_json(p)
    assert back.detect.max_candidates == 80
    assert back.detect.centroid_mode == "band"
    assert back.track.min_marker_distance_px == 25.0
    assert back.track.ring_method == "kmeans"
    assert back.crop_ratios == (0.1, 0.1, 0.0, 0.0)
    # Nested defaults preserved.
    assert back.detect.low_res.blur_small_ksize == 21
    assert back.reconstruct.max_step_displacement_mm == 50.0


def test_config_partial_nested_override_keeps_profile_defaults():
    """Review finding (round 2): a partial JSON override of a nested
    dataclass previously rebuilt it from the CLASS defaults — so
    {"detect": {"high_res": {"dog_threshold": 25}}} silently reset every
    other high-res constant to the LOW-res values (blur 21 instead of 39,
    template 33 instead of 81), degrading >480p detection. Only the present
    keys may change."""
    import json

    from vision_basedsensor_tpu.config import PipelineConfig, from_json

    r = from_json(json.dumps({"detect": {"high_res": {"dog_threshold": 25}}}))
    assert r.detect.high_res.dog_threshold == 25
    base = PipelineConfig().detect.high_res
    assert r.detect.high_res.blur_small_ksize == base.blur_small_ksize == 39
    assert r.detect.high_res.template_size == base.template_size == 81
    # Untouched siblings keep their defaults too.
    assert r.detect.low_res.blur_small_ksize == 21
    assert r.reconstruct.max_axis_ratio == 1.6


def test_config_json_with_removed_detect_keys_still_loads():
    """Configs saved before the detect-backend options were removed carry
    ``backend`` and ``moment_mxu_basis``; they load, the keys are dropped
    and every other field is kept."""
    import json

    from vision_basedsensor_tpu.config import (DetectConfig, PipelineConfig,
                                               from_json, to_json)
    data = json.loads(to_json(PipelineConfig()))
    data["detect"].update(backend="pallas", moment_mxu_basis=True,
                          ncc_threshold=0.2)
    cfg = from_json(json.dumps(data))
    assert cfg.detect.ncc_threshold == 0.2
    assert not hasattr(cfg.detect, "backend")
    assert not hasattr(cfg.detect, "moment_mxu_basis")
    assert cfg.detect.low_res == DetectConfig().low_res
