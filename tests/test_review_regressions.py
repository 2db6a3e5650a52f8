"""Regression tests for the round-1 code-review findings."""

import dataclasses

import cv2
import numpy as np
import pytest

from raw_image_pipeline_tpu import RawImagePipeline, build_pipeline
from raw_image_pipeline_tpu.config import (
    DEFAULT_CALIBRATION_PATH,
    DEFAULT_PARAMS_PATH,
    CameraCalibration,
    PipelineConfig,
)


def _undistort_config():
    from raw_image_pipeline_tpu.config import load_camera_calibration

    cfg = PipelineConfig()
    return PipelineConfig(
        undistortion=dataclasses.replace(cfg.undistortion, enabled=True),
        calibration=load_camera_calibration(DEFAULT_CALIBRATION_PATH),
    )


def test_mono_with_undistortion_shape_and_values():
    """Finding 1: remap on channel-less mono frames."""
    config = _undistort_config()
    rng = np.random.default_rng(0)
    mono = rng.integers(0, 256, (2, 540, 720), np.uint8)
    pipe = build_pipeline(config, "mono8", frame_hw=(540, 720))
    out, _ = pipe(mono)
    got = np.asarray(out["processed"])
    assert got.shape == (2, 540, 720)
    # parity vs cv2 remap on the mono image
    from raw_image_pipeline_tpu.ops.undistortion import (
        estimate_new_camera_matrix,
        init_undistort_rectify_map,
    )

    c = config.calibration
    newK = estimate_new_camera_matrix(c.K(), c.D(), (720, 540), c.R(), 0.0,
                                      (720, 540), 1.0)
    mx, my = init_undistort_rectify_map(c.K(), c.D(), c.R(), newK, (720, 540))
    ref = cv2.remap(mono[0], mx, my, cv2.INTER_LINEAR,
                    borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    np.testing.assert_array_equal(got[0], ref)  # bit-exact since round 5


def test_mono_color_stages_skip_cleanly():
    """Finding 2: color calibration/vignetting/enhancer must not trace-crash
    or corrupt mono frames."""
    cfg = PipelineConfig()
    config = PipelineConfig(
        color_calibration=dataclasses.replace(
            cfg.color_calibration, enabled=True,
            matrix=(1.5, 0.2, 0.1, 0.1, 1.2, 0.1, 0.2, 0.1, 1.1),
        ),
        vignetting_correction=dataclasses.replace(
            cfg.vignetting_correction, enabled=True
        ),
        color_enhancer=dataclasses.replace(cfg.color_enhancer, enabled=True,
                                           saturation_gain=1.5),
    )
    mono = np.random.default_rng(1).integers(0, 256, (1, 24, 32), np.uint8)
    pipe = build_pipeline(config, "mono8", frame_hw=(24, 32))
    out, _ = pipe(mono)
    np.testing.assert_array_equal(np.asarray(out["processed"]), mono)


def test_mono_hw1_layout_flip():
    """Finding 6: [H, W, 1] mono input must rotate H/W, not W/channels."""
    pipe = RawImagePipeline(False, DEFAULT_PARAMS_PATH, "", "")
    pipe.set_white_balance(False)
    pipe.set_undistortion(False)
    pipe.set_flip(True)
    pipe.set_flip_angle(90)
    mono = np.arange(24, dtype=np.uint8).reshape(6, 4, 1)
    out = pipe.process(mono, "mono8")
    assert out.shape == (4, 6, 1)
    np.testing.assert_array_equal(out[..., 0], cv2.flip(cv2.transpose(mono[..., 0]), 1))


def test_multicamera_undistortion_actually_runs():
    """Finding 4: undistortion must trace when per-camera calibrations are
    valid even if the base config carries none."""
    from raw_image_pipeline_tpu.parallel.multicamera import build_multicamera_pipeline

    cfg = PipelineConfig()
    base = PipelineConfig(
        undistortion=dataclasses.replace(cfg.undistortion, enabled=True),
        # note: base carries NO calibration
    )
    calib = CameraCalibration(
        image_width=64, image_height=48,
        camera_matrix=(40.0, 0, 32.0, 0, 40.0, 24.0, 0, 0, 1),
        distortion_coefficients=(-0.04, -0.004, 0.004, -0.002),
        distortion_model="equidistant", calibration_available=True,
    )
    multi = build_multicamera_pipeline(base, [calib, calib], "bayer_gbrg8", (48, 64))
    frames = np.random.default_rng(3).integers(0, 256, (2, 1, 48, 64), np.uint8)
    out, _ = multi(frames)
    # compare against the solo pipeline WITH undistortion
    solo = build_pipeline(base.replace(calibration=calib), "bayer_gbrg8",
                          frame_hw=(48, 64))
    ref, _ = solo(frames[0])
    np.testing.assert_array_equal(
        np.asarray(out["processed"])[0], np.asarray(ref["processed"])
    )
    # and make sure that differs from the no-undistort output
    noop = build_pipeline(base, "bayer_gbrg8", frame_hw=(48, 64))
    plain, _ = noop(frames[0])
    assert not np.array_equal(
        np.asarray(out["processed"])[0], np.asarray(plain["processed"])
    )


def test_api_temporal_consistency_batch_equals_loop():
    """Finding 7: a batch through the API with temporal consistency must
    advance ONE track frame by frame, like the reference stream."""
    img = cv2.imread("tests/fixtures/alphasense.png")
    bayer = img[..., 1]  # any plausible mosaic-ish content

    def fresh():
        p = RawImagePipeline(False, DEFAULT_PARAMS_PATH, "", "")
        p.set_undistortion(False)
        p.set_white_balance_temporal_consistency(True)
        return p

    frames = np.stack([bayer, bayer[::-1].copy(), bayer[:, ::-1].copy()])
    p1 = fresh()
    batch_out = p1.process(frames, "bayer_gbrg8")
    p2 = fresh()
    loop_out = np.stack([p2.process(f, "bayer_gbrg8") for f in frames])
    np.testing.assert_array_equal(batch_out, loop_out)


def test_params_reload_preserves_interpolation():
    """Extension fields with no reference YAML key (remap
    interpolation, new_image_size) must survive a params (re)load — the
    control channel's reload_params used to silently reset a programmatic
    'fixed32' back to the default (round-5 review finding)."""
    import dataclasses

    from raw_image_pipeline_tpu.config import (
        DEFAULT_PARAMS_PATH,
        PipelineConfig,
        load_pipeline_params,
    )

    base = PipelineConfig(
        undistortion=dataclasses.replace(
            PipelineConfig().undistortion,
            interpolation="fixed32", new_image_size=(1440, 1080),
        )
    )
    loaded = load_pipeline_params(DEFAULT_PARAMS_PATH, base)
    assert loaded.undistortion.interpolation == "fixed32"
    assert loaded.undistortion.new_image_size == (1440, 1080)
