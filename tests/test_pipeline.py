"""End-to-end pipeline + API tests, including full-chain parity vs a
cv2-composed golden replicating the reference's stage chain."""

import os

import cv2
import numpy as np
import pytest

from raw_image_pipeline_tpu import (
    PipelineConfig,
    RawImagePipeline,
    build_pipeline,
    load_camera_calibration,
    load_color_calibration,
)
from raw_image_pipeline_tpu.config import (
    DEFAULT_CALIBRATION_PATH,
    DEFAULT_COLOR_CALIBRATION_PATH,
    DEFAULT_PARAMS_PATH,
)
from raw_image_pipeline_tpu.pipeline import init_state
import dataclasses


@pytest.fixture(scope="module")
def bayer_frame():
    """Mosaic the fixture for encoding bayer_gbrg8: the reference demosaics
    it with cv::COLOR_BayerGB2BGR (debayer.cpp:54), whose CFA phase is
    'grbg' under OpenCV's (1,1)-based convention."""
    img = cv2.imread("tests/fixtures/alphasense.png")
    h, w = img.shape[:2]
    bayer = np.zeros((h, w), np.uint8)
    ch = {"g": 1, "b": 0, "r": 2}
    phase = "grbg"  # phase_for_encoding("bayer_gbrg8")
    for k, (di, dj) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        bayer[di::2, dj::2] = img[di::2, dj::2, ch[phase[k]]]
    return bayer


def cv_golden_config1(bayer):
    """BASELINE config 1: debayer bayer_gbrg8 (CPU path incl. swap quirk)
    + gamma k=0.8 LUT."""
    img = cv2.demosaicing(bayer, cv2.COLOR_BayerGB2BGR)
    img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)  # reference CPU swap quirk
    lut = np.array(
        [min(255, max(0, round(float(np.float32((i / 255.0) ** 0.8)) * 255.0)))
         for i in range(256)], np.uint8,
    )
    return cv2.LUT(img, lut)


def test_config1_debayer_gamma_parity(bayer_frame):
    config = PipelineConfig().replace(
        gamma_correction=dataclasses.replace(
            PipelineConfig().gamma_correction, enabled=True, k=0.8
        ),
    )
    pipe = build_pipeline(config, "bayer_gbrg8", frame_hw=bayer_frame.shape)
    out, _ = pipe(bayer_frame[None])
    golden = cv_golden_config1(bayer_frame)
    np.testing.assert_array_equal(np.asarray(out["processed"])[0], golden)


def test_api_default_chain_runs(bayer_frame):
    """Default config: debayer + ccc WB + undistortion (pipeline_params)."""
    pipe = RawImagePipeline(
        False, DEFAULT_PARAMS_PATH, DEFAULT_CALIBRATION_PATH, DEFAULT_COLOR_CALIBRATION_PATH
    )
    out = pipe.process(bayer_frame, "bayer_gbrg8")
    assert out.shape == (540, 720, 3) and out.dtype == np.uint8
    assert pipe.get_dist_debayered_image().shape == (540, 720, 3)
    assert pipe.get_dist_color_image().shape == (540, 720, 3)
    # calibration getters
    assert pipe.get_dist_image_width() == 720
    assert pipe.get_dist_distortion_model() == "equidistant"
    assert pipe.get_rect_distortion_model() == "none"
    K_rect = pipe.get_rect_camera_matrix()
    ref_K = cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(
        pipe.get_dist_camera_matrix(),
        pipe.get_dist_distortion_coefficients().ravel(),
        (720, 540), np.eye(3), balance=0.0, new_size=(720, 540), fov_scale=0.8,
    )
    np.testing.assert_array_equal(K_rect, ref_K)  # bit-exact since round 5


def test_api_full_chain_vs_cv2_golden(bayer_frame):
    """Full 8-stage chain vs the cv2-composed reference composition."""
    pipe = RawImagePipeline(False, DEFAULT_PARAMS_PATH, DEFAULT_CALIBRATION_PATH,
                            DEFAULT_COLOR_CALIBRATION_PATH)
    pipe.set_white_balance_method("pca")
    pipe.set_flip(True)
    pipe.set_flip_angle(180)
    pipe.set_gamma_correction(True)
    pipe.set_gamma_correction_k(0.9)
    pipe.set_color_calibration(True)
    pipe.set_color_enhancer(True)
    pipe.set_color_enhancer_saturation_gain(1.2)
    out = pipe.process(bayer_frame, "bayer_gbrg8")

    # golden with cv2
    img = cv2.demosaicing(bayer_frame, cv2.COLOR_BayerGB2BGR)
    img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    img = cv2.flip(img, -1)
    # pca wb (float64 reference)
    b, g, r = [img[..., i].astype(np.float64) for i in range(3)]

    def pca(c):
        c2 = c * c
        A = np.array([[c2.sum(), c.sum()], [c2.max(), c.max()]])
        x = np.linalg.solve(A, np.array([g.sum(), g.max()]))
        return np.clip(np.rint(np.minimum(x[0] * c2 + x[1] * c, 255.0)), 0, 255).astype(np.uint8)

    img = np.stack([pca(b), img[..., 1], pca(r)], -1)
    cc = load_color_calibration(DEFAULT_COLOR_CALIBRATION_PATH)
    flat = img.reshape(-1, 3).astype(np.float32)
    img = np.clip(
        np.rint(cv2.gemm(flat, cc.matrix_np().T.astype(np.float32), 1.0, None, 0.0)
                + cc.bias_np().astype(np.float32)),
        0, 255,
    ).astype(np.uint8).reshape(img.shape)
    lut = np.array(
        [min(255, max(0, round(float(np.float32((i / 255.0) ** 0.9)) * 255.0)))
         for i in range(256)], np.uint8,
    )
    img = cv2.LUT(img, lut)
    hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    hsv = cv2.multiply(hsv, (1.0, 1.2, 1.0, 0))
    img = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)
    calib = load_camera_calibration(DEFAULT_CALIBRATION_PATH)
    newK = cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(
        calib.K(), calib.D(), (720, 540), calib.R(), balance=0.0,
        new_size=(720, 540), fov_scale=0.8,
    )
    mx, my = cv2.fisheye.initUndistortRectifyMap(calib.K(), calib.D(), calib.R(), newK,
                                                 (720, 540), cv2.CV_32F)
    golden = cv2.remap(img, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT,
                       borderValue=0)

    # The FULL 8-stage chain is bit-exact vs the cv2 composition since
    # round 5: the enhancer mixes cv2's SIMD/scalar HSV2BGR row kernels by
    # column, and the remap replicates cv2's x86/IPP fma-lerp arithmetic
    # (ops/undistortion mode="lerp").
    np.testing.assert_array_equal(out, golden)


def test_temporal_consistency_stream(bayer_frame):
    pipe = RawImagePipeline(False, DEFAULT_PARAMS_PATH, DEFAULT_CALIBRATION_PATH,
                            DEFAULT_COLOR_CALIBRATION_PATH)
    pipe.set_white_balance_temporal_consistency(True)
    pipe.set_undistortion(False)
    out1 = pipe.process(bayer_frame, "bayer_gbrg8")
    out2 = pipe.process(bayer_frame, "bayer_gbrg8")
    # same frame, converged filter: outputs identical
    np.testing.assert_array_equal(out1, out2)
    pipe.reset_white_balance_temporal_consistency()
    out3 = pipe.process(bayer_frame, "bayer_gbrg8")
    np.testing.assert_array_equal(out1, out3)


def test_unsupported_encoding_raises(bayer_frame):
    pipe = RawImagePipeline(False, DEFAULT_PARAMS_PATH, "", "")
    with pytest.raises(ValueError, match="not supported"):
        pipe.process(bayer_frame, "bayer_gbrg16")


def test_passthrough_encoding(bayer_frame):
    """Non-bayer, non-rgb8 encodings pass through debayer untouched
    (debayer.cpp:75)."""
    pipe = RawImagePipeline(False, DEFAULT_PARAMS_PATH, "", "")
    pipe.set_white_balance(False)
    pipe.set_undistortion(False)
    img = cv2.imread("tests/fixtures/alphasense.png")
    out = pipe.process(img, "bgr8")
    np.testing.assert_array_equal(out, img)


def test_batch_equals_loop(bayer_frame):
    config = PipelineConfig().replace(
        white_balance=dataclasses.replace(
            PipelineConfig().white_balance, enabled=True, method="grey_world"
        ),
    )
    pipe = build_pipeline(config, "bayer_gbrg8", frame_hw=bayer_frame.shape)
    b2 = np.stack([bayer_frame, bayer_frame[:, ::-1].copy()])
    out, _ = pipe(b2)
    for i in range(2):
        solo, _ = pipe(b2[i][None])
        np.testing.assert_array_equal(
            np.asarray(out["processed"])[i], np.asarray(solo["processed"])[0]
        )


def test_mono_passthrough_skips_color_stages():
    """mono8-style input: WB/color stages skip (white_balance.hpp:50-52);
    flip and gamma still apply."""
    import dataclasses

    from raw_image_pipeline_tpu.ops.gamma import build_gamma_lut

    cfg = PipelineConfig()
    config = PipelineConfig(
        flip=dataclasses.replace(cfg.flip, enabled=True, angle=180),
        white_balance=dataclasses.replace(cfg.white_balance, enabled=True,
                                          method="grey_world"),
        gamma_correction=dataclasses.replace(cfg.gamma_correction, enabled=True,
                                             k=0.8),
    )
    rng = np.random.default_rng(0)
    mono = rng.integers(0, 256, (2, 24, 32), np.uint8)
    pipe = build_pipeline(config, "mono8", frame_hw=(24, 32))
    out, _ = pipe(mono)
    got = np.asarray(out["processed"])
    lut = build_gamma_lut(0.8)
    ref = lut[mono[:, ::-1, ::-1]]
    np.testing.assert_array_equal(got, ref)


def test_flip90_with_undistortion(bayer_frame):
    """flip 90 swaps H/W; the calibration-sized maps still index the flipped
    frame with clamp+mask semantics like cv::remap would."""
    pipe = RawImagePipeline(False, DEFAULT_PARAMS_PATH, DEFAULT_CALIBRATION_PATH,
                            DEFAULT_COLOR_CALIBRATION_PATH)
    pipe.set_white_balance(False)
    pipe.set_flip(True)
    pipe.set_flip_angle(90)
    out = pipe.process(bayer_frame, "bayer_gbrg8")
    # output is map-shaped (540x720) regardless of the flipped input
    assert out.shape == (540, 720, 3)

    img = cv2.demosaicing(bayer_frame, cv2.COLOR_BayerGB2BGR)
    img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    img = cv2.flip(cv2.transpose(img), 1)
    calib = load_camera_calibration(DEFAULT_CALIBRATION_PATH)
    newK = cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(
        calib.K(), calib.D(), (720, 540), calib.R(), balance=0.0,
        new_size=(720, 540), fov_scale=0.8,
    )
    mx, my = cv2.fisheye.initUndistortRectifyMap(
        calib.K(), calib.D(), calib.R(), newK, (720, 540), cv2.CV_32F
    )
    golden = cv2.remap(img, mx, my, cv2.INTER_LINEAR,
                       borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    np.testing.assert_array_equal(out, golden)  # bit-exact since round 5


def test_1_6mp_calibration_chain(bayer_frame):
    """The second native Alphasense format (1440x1080) with its reference
    calibration: full chain runs and undistortion matches cv2."""
    big = cv2.resize(
        cv2.demosaicing(bayer_frame, cv2.COLOR_BayerGB2BGR), (1440, 1080)
    )
    pipe = RawImagePipeline(
        False, DEFAULT_PARAMS_PATH, "configs/alphasense_calib_1.6mp_example.yaml", ""
    )
    pipe.set_white_balance(False)
    out = pipe.process(big, "bgr8")
    assert out.shape == (1080, 1440, 3)
    calib = load_camera_calibration("configs/alphasense_calib_1.6mp_example.yaml")
    newK = cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(
        calib.K(), calib.D(), (1440, 1080), calib.R(), balance=0.0,
        new_size=(1440, 1080), fov_scale=0.8,
    )
    mx, my = cv2.fisheye.initUndistortRectifyMap(
        calib.K(), calib.D(), calib.R(), newK, (1440, 1080), cv2.CV_32F
    )
    golden = cv2.remap(big, mx, my, cv2.INTER_LINEAR,
                       borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    np.testing.assert_array_equal(out, golden)  # bit-exact since round 5


def test_remap_rejects_mismatched_frame_size():
    """The remap's precomputed anchors are tied to the build-time frame
    size; feeding a different size must raise, not scramble."""
    import pytest as _pytest
    from raw_image_pipeline_tpu.config import PipelineConfig, load_camera_calibration
    from raw_image_pipeline_tpu.pipeline import build_pipeline

    import dataclasses
    cfg = PipelineConfig(
        calibration=load_camera_calibration("configs/alphasense_calib_example.yaml")
    )
    cfg = cfg.replace(
        undistortion=dataclasses.replace(cfg.undistortion, enabled=True)
    )
    pipe = build_pipeline(cfg, "bayer_gbrg8", frame_hw=(540, 720))
    wrong = np.zeros((1, 1080, 1440), np.uint8)
    with _pytest.raises(ValueError, match="remap precomputed for source"):
        pipe(wrong)


@pytest.mark.parametrize("angle", [90, 180, 270])
def test_fast_path_equals_reference_order(bayer_frame, angle):
    """The non-debug fast path (flip hoisted onto the raw mosaic +
    batch-minor internal layout around the remap) must be bit-identical to
    the debug path, which keeps the reference's stage order and layout."""
    cfg = PipelineConfig(
        flip=dataclasses.replace(PipelineConfig().flip, enabled=True, angle=angle),
        vignetting_correction=dataclasses.replace(
            PipelineConfig().vignetting_correction,
            enabled=True, scale=1.2, a2=1e-3, a4=1e-6,
        ),
        undistortion=dataclasses.replace(
            PipelineConfig().undistortion, enabled=True
        ),
        calibration=load_camera_calibration(DEFAULT_CALIBRATION_PATH),
    )
    h, w = bayer_frame.shape
    fast = build_pipeline(cfg, "bayer_gbrg8", frame_hw=(h, w))
    ref = build_pipeline(cfg, "bayer_gbrg8", frame_hw=(h, w), debug=True)
    batch = np.stack([bayer_frame, bayer_frame[::-1, ::-1].copy()])
    of, _ = fast(batch)
    orf, _ = ref(batch)
    np.testing.assert_array_equal(
        np.asarray(of["processed"]), np.asarray(orf["processed"])
    )


@pytest.mark.parametrize("stateful", [False, True])
def test_microbatch_equals_unchunked(bayer_frame, stateful):
    """microbatch=k (lax.map / lax.scan chunks inside one dispatch) is
    bitwise identical to the unchunked program, including the temporal
    track threaded across chunks."""
    cfg = PipelineConfig()
    cfg = cfg.replace(
        white_balance=dataclasses.replace(
            cfg.white_balance, enabled=True, method="ccc",
            temporal_consistency=stateful,
        )
    )
    h, w = bayer_frame.shape
    batch = np.stack([np.roll(bayer_frame, i, axis=0) for i in range(6)])
    from raw_image_pipeline_tpu.pipeline import init_state

    plain = build_pipeline(cfg, "bayer_gbrg8", frame_hw=(h, w),
                           with_state=stateful, temporal_mode="sequence")
    micro = build_pipeline(cfg, "bayer_gbrg8", frame_hw=(h, w),
                           with_state=stateful, temporal_mode="sequence",
                           microbatch=2)
    st = init_state(()) if stateful else None
    op, sp = plain(batch, st)
    om, sm = micro(batch, st)
    np.testing.assert_array_equal(
        np.asarray(op["processed"]), np.asarray(om["processed"])
    )
    if stateful:
        np.testing.assert_array_equal(np.asarray(sp.x), np.asarray(sm.x))


def test_flip_odd_size_frames_match_cv2():
    """Odd-sized frames can't hoist the flip onto the mosaic (pattern
    parity shifts); the guard must fall back to post-debayer flipping and
    still match cv2 exactly."""
    rng = np.random.default_rng(7)
    bay = rng.integers(0, 256, (31, 47), np.uint8)
    cfg = PipelineConfig(
        flip=dataclasses.replace(PipelineConfig().flip, enabled=True, angle=180)
    )
    h, w = bay.shape
    pipe = build_pipeline(cfg, "bayer_gbrg8", frame_hw=(h, w))
    out, _ = pipe(bay[None])
    ref = cv2.demosaicing(bay, cv2.COLOR_BayerGB2BGR)
    ref = cv2.cvtColor(ref, cv2.COLOR_RGB2BGR)
    ref = cv2.flip(ref, -1)
    np.testing.assert_array_equal(np.asarray(out["processed"][0]), ref)


def test_corrections_keyed_on_default_device_platform():
    """Per-platform LUT corrections follow the default device the pipeline
    is built under, not jax.default_backend(): a pipeline built inside
    jax.default_device(cpu) keys its tables on "cpu"."""
    import jax

    import __graft_entry__ as ge
    from raw_image_pipeline_tpu.ops import colorspace
    from raw_image_pipeline_tpu.ops.lut import current_platform
    from raw_image_pipeline_tpu.pipeline import (
        _composed_fit_cached,
        _composed_gamma_fit,
        build_pipeline,
    )

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        assert current_platform() == "cpu"
    with jax.default_device("cpu"):
        assert current_platform() == "cpu"
    assert current_platform() == jax.default_backend()

    hw = (32, 48)
    with jax.default_device(cpu):
        pipe = build_pipeline(ge._full_config(hw), "bayer_gbrg8",
                              frame_hw=hw)
        out, _ = pipe(np.zeros((1,) + hw, np.uint8))
        jax.block_until_ready(out)
    assert "cpu" in colorspace._LAB_CBRT._corr
    with jax.default_device(cpu):
        assert _composed_gamma_fit(0.9) is _composed_fit_cached(0.9, "cpu")


def test_stage_scopes_and_device_time_reduction():
    """The trace reduction's two halves: every stage scope of the compiled
    chain is recovered from its HLO metadata, and event durations sum per
    stage (unknown instructions under "other")."""
    import __graft_entry__ as ge
    from raw_image_pipeline_tpu.pipeline import build_pipeline
    from raw_image_pipeline_tpu.utils.profiling import (
        hlo_stage_scopes,
        stage_device_times,
    )

    hw = (32, 48)
    pipe = build_pipeline(ge._full_config(hw), "bayer_gbrg8", frame_hw=hw)
    hlo = pipe.fn.lower(pipe.params, np.zeros((2,) + hw, np.uint8),
                        None).compile().as_text()
    scopes = hlo_stage_scopes(hlo)
    assert {"isp_debayer", "isp_white_balance", "isp_color_calibration",
            "isp_vignetting", "isp_color_enhancer",
            "isp_undistortion"} <= set(scopes.values())
    a, b = sorted(scopes)[:2]
    got = stage_device_times([(a, 5), (b, 7), ("no-such-op", 11), (a, 1)],
                             scopes)
    want = {}
    for name, dur in ((a, 6), (b, 7)):
        want[scopes[name]] = want.get(scopes[name], 0) + dur
    want["other"] = 11
    assert got == want
