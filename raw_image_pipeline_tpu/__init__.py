"""raw_image_pipeline_tpu — RAW-image ISP engine in JAX/XLA.

A brand-new JAX/XLA implementation of the full ISP chain of
leggedrobotics/raw_image_pipeline (debayer, flip, white balance incl. FFCC
convolutional color constancy, color calibration, gamma, vignetting
correction, HSV color enhancement, fisheye undistortion), re-designed for
batched, sharded execution on one to four GPUs.

Public API:
    RawImagePipeline — drop-in Python API matching the reference's pybind11
        surface (reference: raw_image_pipeline_python/src/raw_image_pipeline_python.cpp:14-73).
    PipelineConfig / load_pipeline_params / load_camera_calibration /
    load_color_calibration — config layer reading the reference's exact YAML
        schemas (reference: raw_image_pipeline/src/raw_image_pipeline/raw_image_pipeline.cpp:44-165).
    build_pipeline — functional core: returns a jitted (params, state, batch)
        -> (batch', state') ISP function.
"""

from raw_image_pipeline_tpu.config import (
    PipelineConfig,
    DebayerConfig,
    FlipConfig,
    WhiteBalanceConfig,
    ColorCalibrationConfig,
    GammaCorrectionConfig,
    VignettingCorrectionConfig,
    ColorEnhancerConfig,
    UndistortionConfig,
    CameraCalibration,
    load_pipeline_params,
    load_camera_calibration,
    load_color_calibration,
)
from raw_image_pipeline_tpu.pipeline import build_pipeline, IspState
from raw_image_pipeline_tpu.api import RawImagePipeline

__version__ = "0.1.0"

__all__ = [
    "RawImagePipeline",
    "PipelineConfig",
    "DebayerConfig",
    "FlipConfig",
    "WhiteBalanceConfig",
    "ColorCalibrationConfig",
    "GammaCorrectionConfig",
    "VignettingCorrectionConfig",
    "ColorEnhancerConfig",
    "UndistortionConfig",
    "CameraCalibration",
    "load_pipeline_params",
    "load_camera_calibration",
    "load_color_calibration",
    "build_pipeline",
    "IspState",
    "__version__",
]
