"""Fisheye undistortion parity vs cv2.fisheye + cv2.remap."""

import cv2
import numpy as np
import pytest

from raw_image_pipeline_tpu.ops.undistortion import (
    estimate_new_camera_matrix,
    fisheye_undistort_points,
    init_undistort_rectify_map,
    remap_bilinear_u8_from_maps,
)

K = np.array(
    [[347.548139773951, 0, 342.454373227748],
     [0, 347.434712422309, 271.368057185649],
     [0, 0, 1]]
)
D = np.array([-0.0396482888762527, -0.00367688950406141, 0.00391742438164282, -0.00178738156007817])
R = np.eye(3)
SIZE = (720, 540)  # (width, height)


def test_undistort_points_exact():
    pts = np.array([[360, 0], [720, 270], [360, 540], [0, 270], [100, 100]], float)
    ref = cv2.fisheye.undistortPoints(pts.reshape(1, -1, 2), K, D, R=R).reshape(-1, 2)
    mine = fisheye_undistort_points(pts, K, D, R)
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("balance,fov_scale", [(0.0, 1.0), (0.5, 1.2), (0.0, 0.8), (1.0, 1.0)])
def test_estimate_new_camera_matrix_exact(balance, fov_scale):
    ref = cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(
        K, D, SIZE, R, balance=balance, new_size=SIZE, fov_scale=fov_scale
    )
    mine = estimate_new_camera_matrix(K, D, SIZE, R, balance, SIZE, fov_scale)
    np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-9)


def test_init_maps_exact():
    newK = cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(
        K, D, SIZE, R, balance=0.0, new_size=SIZE, fov_scale=0.8
    )
    mx_ref, my_ref = cv2.fisheye.initUndistortRectifyMap(K, D, R, newK, SIZE, cv2.CV_32F)
    mx, my = init_undistort_rectify_map(K, D, R, newK, SIZE)
    np.testing.assert_array_equal(mx, mx_ref)
    np.testing.assert_array_equal(my, my_ref)


def test_remap_parity_random_maps():
    rng = np.random.default_rng(31)
    img = rng.integers(0, 256, (60, 80, 3), np.uint8)
    mx = rng.uniform(-5, 85, (50, 70)).astype(np.float32)
    my = rng.uniform(-5, 65, (50, 70)).astype(np.float32)
    ref = cv2.remap(img, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    out = np.asarray(remap_bilinear_u8_from_maps(img, mx, my))
    np.testing.assert_array_equal(out, ref)


def test_full_undistortion_on_fixture():
    img = cv2.imread("tests/fixtures/alphasense.png")
    newK = estimate_new_camera_matrix(K, D, SIZE, R, 0.0, SIZE, 0.8)
    mx, my = init_undistort_rectify_map(K, D, R, newK, SIZE)
    ref = cv2.remap(img, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    out = np.asarray(remap_bilinear_u8_from_maps(img[None], mx, my))[0]
    np.testing.assert_array_equal(out, ref)  # bit-exact since round 5
    # batched consistency
    out2 = np.asarray(remap_bilinear_u8_from_maps(np.stack([img, img]), mx, my))
    np.testing.assert_array_equal(out2[0], out2[1])


def test_new_image_size_scales_rect_K():
    """setNewImageSize semantics: rect K scales to the new size, maps and
    output stay calibration-sized (undistortion.cpp:28-31, 216-238)."""
    from raw_image_pipeline_tpu import RawImagePipeline
    from raw_image_pipeline_tpu.config import DEFAULT_CALIBRATION_PATH, DEFAULT_PARAMS_PATH

    pipe = RawImagePipeline(False, DEFAULT_PARAMS_PATH, DEFAULT_CALIBRATION_PATH, "")
    pipe.set_white_balance(False)
    pipe.set_undistortion_balance(0.0)
    pipe.set_undistortion_fov_scale(1.0)
    pipe.set_undistortion_new_image_size(1440, 1080)
    assert pipe.get_rect_image_width() == 1440
    K_rect = pipe.get_rect_camera_matrix()
    ref = cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(
        K, D, SIZE, R, balance=0.0, new_size=(1440, 1080), fov_scale=1.0
    )
    np.testing.assert_array_equal(K_rect, ref)  # bit-exact since round 5

    # output remains at the calibration size
    img = cv2.imread("tests/fixtures/alphasense.png")
    out = pipe.process(img, "bgr8")
    assert out.shape == (540, 720, 3)
    mx, my = cv2.fisheye.initUndistortRectifyMap(K, D, R, ref, SIZE, cv2.CV_32F)
    golden = cv2.remap(img, mx, my, cv2.INTER_LINEAR,
                       borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    np.testing.assert_array_equal(out, golden)  # bit-exact since round 5


def test_remap_precompute_concentrates_oob_indices():
    """Fully out-of-image output pixels (all-zero weights) gather from row 0
    so their indices hit one cached row; partially-in-range pixels keep
    their real anchors."""
    from raw_image_pipeline_tpu.ops.undistortion import remap_precompute

    h, w = 8, 10
    mx = np.full((4, 6), -50.0, np.float32)  # entirely out of range
    my = np.full((4, 6), -50.0, np.float32)
    mx[0, 0], my[0, 0] = 3.5, 2.5            # one valid interior sample
    # lerp (default): weight rows 2-5 are the tap masks; base carries the
    # pack's +(w+1) margin, and all-out pixels point at margin row 0
    base, weights = remap_precompute(mx, my, (h, w))
    oob = (weights[2:] == 0).all(axis=0)
    assert oob.sum() == 23 and not oob[0]
    np.testing.assert_array_equal(base[oob], 0)
    assert base[0] == (2 * w + 3) + (w + 1)
    # fixed32/float: 4 per-slot weights, no margin
    for mode in ("fixed32", "float"):
        base, weights = remap_precompute(mx, my, (h, w), mode=mode)
        oob = (weights == 0).all(axis=0)
        assert oob.sum() == 23 and not oob[0], mode
        np.testing.assert_array_equal(base[oob], 0)
        assert base[0] == 2 * w + 3, mode


@pytest.mark.parametrize("mode_env", ["lerp", "fixed32", "float"])
def test_remap_camera_blocked_matches_per_camera(mode_env):
    # the camera-blocked gather (stacked base/weights, row-concatenated
    # packs) must equal independent per-camera remaps for all three entry
    # layouts: planes, batch-minor packed, batch-major packed — in every
    # remap arithmetic mode
    import jax.numpy as jnp
    from raw_image_pipeline_tpu.ops.undistortion import (
        remap_bilinear_u8,
        remap_bilinear_u8_planes,
        remap_precompute,
    )

    rng = np.random.default_rng(5)
    h, w, bc = 24, 32, 3
    imgs = rng.integers(0, 256, (2, bc, h, w, 3), np.uint8)  # [cam, B, H, W, C]
    # camera-blocked stacking must hold in every remap mode (lerp stacks
    # [C, 6, N] weights, fixed32/float [C, 4, N])
    mode = mode_env
    bases, weightss = [], []
    for cam in range(2):
        mx = rng.uniform(-2, w + 1, (h, w)).astype(np.float32)
        my = rng.uniform(-2, h + 1, (h, w)).astype(np.float32)
        b_, w_ = remap_precompute(mx, my, (h, w), mode=mode)
        bases.append(b_)
        weightss.append(w_)
    base2 = jnp.asarray(np.stack(bases))
    weights2 = jnp.asarray(np.stack(weightss))

    # reference: per-camera single remaps
    refs = [
        np.asarray(
            remap_bilinear_u8(
                jnp.asarray(imgs[cam]), jnp.asarray(bases[cam]),
                jnp.asarray(weightss[cam]), (h, w), mode=mode,
            )
        )
        for cam in range(2)
    ]

    for tuning in ((2, 130_000), (4, 550_000), (2, 100), (4, 100)):
        # batch-major packed [cam*B, H, W, C]
        out = np.asarray(
            remap_bilinear_u8(
                jnp.asarray(imgs.reshape(2 * bc, h, w, 3)), base2, weights2,
                (h, w), n_cameras=2, tuning=tuning, mode=mode,
            )
        ).reshape(2, bc, h, w, 3)
        for cam in range(2):
            np.testing.assert_array_equal(out[cam], refs[cam])

        # batch-minor packed [H, W, cam*B, C]
        bm = jnp.asarray(np.transpose(imgs.reshape(2 * bc, h, w, 3), (1, 2, 0, 3)))
        out_bm = np.asarray(
            remap_bilinear_u8(
                bm, base2, weights2, (h, w), batch_minor=True,
                n_cameras=2, tuning=tuning, mode=mode,
            )
        )  # [2, Ho, Wo, B, C]
        for cam in range(2):
            np.testing.assert_array_equal(
                np.transpose(out_bm[cam], (2, 0, 1, 3)), refs[cam]
            )

        # planes [H, W, cam*B] x3
        planes = tuple(
            jnp.asarray(np.transpose(imgs.reshape(2 * bc, h, w, 3)[..., c], (1, 2, 0)))
            for c in range(3)
        )
        out_p = np.asarray(
            remap_bilinear_u8_planes(
                planes, base2, weights2, (h, w), n_cameras=2, tuning=tuning,
                mode=mode,
            )
        )  # [2, Ho, Wo, C, B]
        for cam in range(2):
            np.testing.assert_array_equal(
                np.transpose(out_p[cam], (3, 0, 1, 2)), refs[cam]
            )


def test_remap_lerp_exact_vs_cv2_fisheye_maps():
    """Default mode ("lerp") = cv2 5.0's x86/IPP fma-lerp arithmetic:
    bit-exact on the real fisheye maps over full frames (the old float
    formulation differed at ~4 per million boundary pixels)."""
    import jax.numpy as jnp

    newK = estimate_new_camera_matrix(K, D, SIZE, R, 0.0, SIZE, 0.8)
    mx, my = init_undistort_rectify_map(K, D, R, newK, SIZE)
    for seed in range(3):
        img = np.random.default_rng(seed).integers(0, 256, (540, 720, 3), np.uint8)
        ref = cv2.remap(img, mx, my, cv2.INTER_LINEAR,
                        borderMode=cv2.BORDER_CONSTANT, borderValue=0)
        out = np.asarray(remap_bilinear_u8_from_maps(img, mx, my))
        np.testing.assert_array_equal(out, ref, err_msg=f"seed {seed}")


def test_remap_fixed32_exact_vs_cv2_converted_maps():
    """mode="fixed32" = OpenCV's non-IPP INTER_BITS=5 integer path (the
    reference's ARM/Jetson deployment): bit-exact against cv2 fed
    pre-converted CV_16SC2 fixed-point maps, which forces that path."""
    import jax.numpy as jnp

    from raw_image_pipeline_tpu.ops.undistortion import (
        remap_bilinear_u8,
        remap_precompute,
    )

    newK = estimate_new_camera_matrix(K, D, SIZE, R, 0.0, SIZE, 0.8)
    mx, my = init_undistort_rectify_map(K, D, R, newK, SIZE)
    m1, m2 = cv2.convertMaps(mx, my, cv2.CV_16SC2)
    img = np.random.default_rng(5).integers(0, 256, (540, 720, 3), np.uint8)
    ref = cv2.remap(img, m1, m2, cv2.INTER_LINEAR,
                    borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    base, wts = remap_precompute(mx, my, (540, 720), mode="fixed32")
    out = np.asarray(remap_bilinear_u8(
        jnp.asarray(img)[None], jnp.asarray(base), jnp.asarray(wts),
        (540, 720), (540, 720), mode="fixed32",
    ))[0]
    np.testing.assert_array_equal(out, ref)

    # random wild maps too (borders + far out-of-range)
    rng = np.random.default_rng(6)
    mxw = rng.uniform(-20, 90, (40, 50)).astype(np.float32)
    myw = rng.uniform(-20, 70, (40, 50)).astype(np.float32)
    m1, m2 = cv2.convertMaps(mxw, myw, cv2.CV_16SC2)
    img = rng.integers(0, 256, (60, 72, 3), np.uint8)
    ref = cv2.remap(img, m1, m2, cv2.INTER_LINEAR,
                    borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    base, wts = remap_precompute(mxw, myw, (60, 72), mode="fixed32")
    out = np.asarray(remap_bilinear_u8(
        jnp.asarray(img)[None], jnp.asarray(base), jnp.asarray(wts),
        (40, 50), (60, 72), mode="fixed32",
    ))[0]
    np.testing.assert_array_equal(out, ref)


def test_pipeline_interpolation_fixed32_matches_jetson_path():
    """The config/API knob selects the ARM/Jetson (non-IPP) remap
    arithmetic end-to-end: pipeline output equals cv2 forced onto its
    fixed-point path via pre-converted maps."""
    from raw_image_pipeline_tpu import RawImagePipeline
    from raw_image_pipeline_tpu.config import (
        DEFAULT_CALIBRATION_PATH,
        DEFAULT_PARAMS_PATH,
    )

    img = cv2.imread("tests/fixtures/alphasense.png")
    pipe = RawImagePipeline(False, DEFAULT_PARAMS_PATH,
                            DEFAULT_CALIBRATION_PATH, "")
    pipe.set_white_balance(False)
    pipe.set_undistortion(True)
    pipe.set_undistortion_balance(0.0)
    pipe.set_undistortion_fov_scale(0.8)
    pipe.set_undistortion_interpolation("fixed32")
    out = pipe.process(img, "bgr8")

    newK = estimate_new_camera_matrix(K, D, SIZE, R, 0.0, SIZE, 0.8)
    mx, my = init_undistort_rectify_map(K, D, R, newK, SIZE)
    m1, m2 = cv2.convertMaps(mx, my, cv2.CV_16SC2)
    golden = cv2.remap(img, m1, m2, cv2.INTER_LINEAR,
                       borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    np.testing.assert_array_equal(out, golden)


@pytest.mark.parametrize("size", [(99, 77), (101, 75), (720, 540), (98, 76)])
def test_estimate_new_camera_matrix_odd_sizes(size):
    """cv2's boundary sample points use C++ INTEGER division for the
    midpoints — visible only at ODD image sizes (round-5 finding: float
    halves shifted newK ~0.3 px and broke full-chain parity there)."""
    w, h = size
    sx, sy = w / 720.0, h / 540.0
    Ks = np.array([[347.5 * sx, 0, 342.45 * sx],
                   [0, 347.4 * sy, 271.37 * sy], [0, 0, 1]])
    for balance, fov in ((0.0, 1.0), (0.3, 1.1), (1.0, 0.8)):
        ref = cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(
            Ks, D, (w, h), R, balance=balance, new_size=(w, h), fov_scale=fov
        )
        mine = estimate_new_camera_matrix(Ks, D, (w, h), R, balance,
                                          (w, h), fov)
        np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-9)
        # map parity given the same newK (a <=1e-9 newK difference can
        # still flip f32 map ulps, so the estimate and the map builder
        # are asserted separately)
        mx_ref, my_ref = cv2.fisheye.initUndistortRectifyMap(
            Ks, D, R, ref, (w, h), cv2.CV_32F)
        mx, my = init_undistort_rectify_map(Ks, D, R, ref, (w, h))
        np.testing.assert_array_equal(mx, mx_ref)
        np.testing.assert_array_equal(my, my_ref)


def test_full_chain_bit_exact_odd_frame():
    """Full chain (gamma+vig+enhancer+undistortion) on an ODD-sized frame
    is bit-exact vs the cv2 golden — exercises the xla debayer fallback,
    the enhancer's scalar column tail, and the odd-size fisheye init."""
    import dataclasses

    from raw_image_pipeline_tpu.config import CameraCalibration, PipelineConfig
    from raw_image_pipeline_tpu.ops.gamma import build_gamma_lut
    from raw_image_pipeline_tpu.ops.vignetting import build_vignetting_mask
    from raw_image_pipeline_tpu.pipeline import build_pipeline

    h, w = 77, 99
    rng = np.random.default_rng(3)
    bay = rng.integers(0, 256, (h, w), np.uint8)
    sx, sy = w / 720.0, h / 540.0
    calib = CameraCalibration(
        image_width=w, image_height=h,
        camera_matrix=(347.5 * sx, 0.0, 342.45 * sx,
                       0.0, 347.4 * sy, 271.37 * sy, 0.0, 0.0, 1.0),
        distortion_coefficients=(-0.0396, -0.0037, 0.0039, -0.0018),
        distortion_model="equidistant", calibration_available=True)
    cfg0 = PipelineConfig()
    cfg = PipelineConfig(
        gamma_correction=dataclasses.replace(
            cfg0.gamma_correction, enabled=True, k=0.9),
        vignetting_correction=dataclasses.replace(
            cfg0.vignetting_correction, enabled=True, scale=1.5,
            a2=1e-3, a4=1e-6),
        color_enhancer=dataclasses.replace(
            cfg0.color_enhancer, enabled=True, saturation_gain=1.2),
        undistortion=dataclasses.replace(
            cfg0.undistortion, enabled=True, balance=0.0, fov_scale=1.0),
        calibration=calib)
    pipe = build_pipeline(cfg, "bayer_gbrg8", frame_hw=(h, w))
    out, _ = pipe(bay[None])
    got = np.asarray(out["processed"])[0]

    img = cv2.demosaicing(bay, cv2.COLOR_BayerGB2BGR)
    img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    img = cv2.LUT(img, build_gamma_lut(0.9))
    mask = build_vignetting_mask(h, w, 1.5, 1e-3, 1e-6)
    lab = cv2.cvtColor(img, cv2.COLOR_BGR2Lab)
    L = lab[..., 0].astype(np.float32) * mask
    lab[..., 0] = np.clip(np.rint(L), 0, 255).astype(np.uint8)
    img = cv2.cvtColor(lab, cv2.COLOR_Lab2BGR)
    hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    hsv = cv2.multiply(hsv, (1.0, 1.2, 1.0, 0))
    img = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)
    newK = cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(
        calib.K(), calib.D(), (w, h), calib.R(), balance=0.0,
        new_size=(w, h), fov_scale=1.0)
    mx, my = cv2.fisheye.initUndistortRectifyMap(
        calib.K(), calib.D(), calib.R(), newK, (w, h), cv2.CV_32F)
    golden = cv2.remap(img, mx, my, cv2.INTER_LINEAR,
                       borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    np.testing.assert_array_equal(got, golden)


def test_fisheye_init_random_intrinsics_exact():
    """Random K/D/balance/fov/size sweep, newK AND maps bit-exact vs cv2.
    Pins three round-5 findings a fixed-calibration test can't reach:
    (1) non-converged undistortPoints get the library's (-1e6,-1e6)
    sentinel (wild D -> degenerate newK must match cv2's, not a
    'better' one); (2) the Newton solve's last-ulp op order
    (3*(k0*t2), libm tan); (3) the iR inverse is the closed-form
    adjugate (cv::Matx DECOMP_LU), not LAPACK LU — 1-ulp iR diffs flip
    f32 map values at cancellation pixels (~1 px / 400 frames)."""
    checked = 0
    for seed in (3, 95, 103, 129, 202, 229, 343, 0, 7, 11, 17, 23):
        rng = np.random.default_rng(seed)
        h = int(rng.integers(40, 800))
        w = int(rng.integers(40, 1000))
        fx = float(rng.uniform(0.4, 1.5) * w)
        fy = float(rng.uniform(0.4, 1.5) * h)
        cx = float(rng.uniform(0.3, 0.7) * w)
        cy = float(rng.uniform(0.3, 0.7) * h)
        Kr = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        Dr = rng.normal(0, 0.15, 4).astype(np.float64)
        balance = float(rng.choice([0.0, 0.3, 0.5, 1.0]))
        fov = float(rng.choice([0.6, 0.8, 1.0, 1.2, 2.0]))
        try:
            nk_cv = cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(
                Kr, Dr.reshape(-1, 1), (w, h), R, balance=balance,
                new_size=(w, h), fov_scale=fov)
            mx_cv, my_cv = cv2.fisheye.initUndistortRectifyMap(
                Kr, Dr.reshape(-1, 1), R, nk_cv, (w, h), cv2.CV_32F)
        except cv2.error:
            continue
        nk = estimate_new_camera_matrix(Kr, Dr, (w, h), R, balance,
                                        (w, h), fov)
        if np.isnan(nk_cv).any():
            assert (np.isnan(nk) == np.isnan(nk_cv)).all(), seed
            continue
        np.testing.assert_array_equal(nk, nk_cv, err_msg=f"seed {seed}")
        mx, my = init_undistort_rectify_map(Kr, Dr, R, nk, (w, h))
        np.testing.assert_array_equal(mx, mx_cv, err_msg=f"seed {seed}")
        np.testing.assert_array_equal(my, my_cv, err_msg=f"seed {seed}")
        checked += 1
    assert checked >= 8


@pytest.mark.parametrize("mode", ["lerp", "fixed32"])
def test_remap_hostile_random_maps_exact(mode):
    """Random (non-smooth) maps with mixed in-range / boundary / far-OOB
    coordinates, bit-exact vs cv2.remap in both arithmetics — fisheye maps
    are smooth, so only hostile maps stress the border masks, the margin-
    baked base and the int16 saturation of the fixed-point path. Also
    drives remap_bilinear_u8_from_maps's mode threading (round-5 fix)."""
    import jax.numpy as jnp

    from raw_image_pipeline_tpu.ops.undistortion import (
        remap_bilinear_u8_from_maps,
    )

    for seed in (0, 1, 2, 3):
        rng = np.random.default_rng(seed)
        sh, sw = int(rng.integers(8, 120)), int(rng.integers(8, 120))
        dh, dw = int(rng.integers(8, 120)), int(rng.integers(8, 120))
        img = rng.integers(0, 256, (sh, sw, 3), np.uint8)
        if seed == 1:  # far OOB (int16 saturation territory)
            mx = rng.uniform(-1e5, 1e5, (dh, dw)).astype(np.float32)
            my = rng.uniform(-1e5, 1e5, (dh, dw)).astype(np.float32)
        elif seed == 2:  # exact integer/half coords (boundary class)
            mx = (rng.integers(-2, 2 * sw + 4, (dh, dw)) / 2.0).astype(np.float32)
            my = (rng.integers(-2, 2 * sh + 4, (dh, dw)) / 2.0).astype(np.float32)
        else:
            mx = rng.uniform(-3, sw + 3, (dh, dw)).astype(np.float32)
            my = rng.uniform(-3, sh + 3, (dh, dw)).astype(np.float32)
        if mode == "fixed32":
            m1, m2 = cv2.convertMaps(mx, my, cv2.CV_16SC2)
            golden = cv2.remap(img, m1, m2, cv2.INTER_LINEAR,
                               borderMode=cv2.BORDER_CONSTANT, borderValue=0)
        else:
            golden = cv2.remap(img, mx, my, cv2.INTER_LINEAR,
                               borderMode=cv2.BORDER_CONSTANT, borderValue=0)
        got = np.asarray(
            remap_bilinear_u8_from_maps(jnp.asarray(img[None]), mx, my,
                                        mode=mode))[0]
        np.testing.assert_array_equal(got, golden, err_msg=f"seed {seed}")


def test_auto_tuning_latency_form_bitwise_equal():
    """tuning=None resolves by flattened source width: a single color frame
    (3 columns) engages the 4-slot latency form, wider batches keep the
    2-slot throughput default — and both forms are bit-identical to the
    cv2 golden and to each other (the 4-slot pack spends half the gather
    indices at B=1)."""
    import jax.numpy as jnp

    from raw_image_pipeline_tpu.ops.undistortion import (
        DEFAULT_REMAP_TUNING,
        LATENCY_REMAP_TUNING,
        _resolve_tuning,
        remap_bilinear_u8,
        remap_precompute,
    )

    assert _resolve_tuning(None, 3) == LATENCY_REMAP_TUNING
    assert _resolve_tuning(None, 4) == LATENCY_REMAP_TUNING
    assert _resolve_tuning(None, 48) == DEFAULT_REMAP_TUNING
    assert _resolve_tuning((2, 99), 3) == (2, 99)

    rng = np.random.default_rng(77)
    img = rng.integers(0, 256, (64, 96, 3), np.uint8)
    mx = rng.uniform(-4, 100, (50, 70)).astype(np.float32)
    my = rng.uniform(-4, 68, (50, 70)).astype(np.float32)
    golden = cv2.remap(img, mx, my, cv2.INTER_LINEAR,
                       borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    base, weights = remap_precompute(mx, my, img.shape[:2])
    base, weights = jnp.asarray(base), jnp.asarray(weights)
    for tuning in (None, DEFAULT_REMAP_TUNING, LATENCY_REMAP_TUNING):
        out = np.asarray(remap_bilinear_u8(
            img[None], base, weights, (50, 70), img.shape[:2], tuning=tuning
        ))[0]
        np.testing.assert_array_equal(out, golden, err_msg=f"tuning {tuning}")
