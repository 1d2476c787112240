"""vision_basedsensor_tpu — vision-based tactile sensor framework in JAX.

A ground-up JAX/XLA rebuild of the capabilities of
UPM-ROB-Lab/Vision-basedSensor (embedded vision-based tactile sensor for
bonnet polishing): batched marker detection, identity tracking, monocular 3D
displacement-field reconstruction, contact-force distribution and
pose-misalignment (tilt) estimation, plus camera calibration, synthetic data
generation, host I/O, and an acquisition/streaming server.

Architecture (see SURVEY.md §7 and README.md): the reference's five
file-coupled scripts become one jitted array program over batched frames with
fixed shapes and validity masks; host shells handle video decode and
artifacts.
"""

__version__ = "0.1.0"

from vision_basedsensor_tpu import layout
from vision_basedsensor_tpu.config import PipelineConfig, from_json, to_json
from vision_basedsensor_tpu.core.camera import CameraModel

__all__ = [
    "PipelineConfig", "CameraModel", "layout", "from_json", "to_json",
    "detect_markers", "assign_identities", "associate", "run_video",
    "process_frames", "initialize", "StreamingPipeline", "__version__",
]


def __getattr__(name):  # lazy: keep bare `import vision_basedsensor_tpu` light
    if name in ("detect_markers",):
        from vision_basedsensor_tpu.detect import detect_markers
        return detect_markers
    if name in ("assign_identities", "associate"):
        from vision_basedsensor_tpu import track
        return getattr(track, name)
    if name in ("run_video", "process_frames", "initialize", "StreamingPipeline"):
        from vision_basedsensor_tpu import pipeline
        return getattr(pipeline, name)
    raise AttributeError(name)
