"""CCC (FFCC) white-balance parity tests.

Goldens are built by replicating the reference C++ math with cv2 + numpy
primitives (resize, dft, minMaxLoc), mirroring
convolutional_color_constancy.cpp stage by stage.
"""

import cv2
import jax
import numpy as np
import pytest

from raw_image_pipeline_tpu.config import DEFAULT_CCC_MODEL_PATH
from raw_image_pipeline_tpu.models.ccc_model import load_ccc_model
from raw_image_pipeline_tpu.ops import ccc
from raw_image_pipeline_tpu.ops.resize import resize_linear_u8

MODEL = load_ccc_model(DEFAULT_CCC_MODEL_PATH)


def cv_reference_ccc(img, bright=0.9, dark=0.1):
    """Reference balanceWhite math via cv2 primitives (ccc.cpp:91-113)."""
    small = cv2.resize(img, (ccc.SMALL_W, ccc.SMALL_H))
    f = small.astype(np.float32)
    gray = cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)
    include = (gray <= 255.0 * bright) & (gray > 255.0 * dark)
    with np.errstate(divide="ignore", invalid="ignore"):
        logs = np.log(f)
        finite = np.isfinite(logs).all(-1)
        valid = include & finite
        # inf-inf -> nan on zero pixels; masked out by `valid`
        u = np.round((logs[..., 1] - logs[..., 2] - ccc.UV0) / ccc.BIN_SIZE)
        v = np.round((logs[..., 1] - logs[..., 0] - ccc.UV0) / ccc.BIN_SIZE)
    u = np.clip(np.nan_to_num(u), 0, 255).astype(np.int64)
    v = np.clip(np.nan_to_num(v), 0, 255).astype(np.int64)
    hist = np.zeros((256, 256), np.float32)
    w = np.float32(1.0 / (small.shape[0] * small.shape[1]))
    np.add.at(hist, (u[valid], v[valid]), w)

    hist_fft = cv2.dft(hist, flags=0, nonzeroRows=256)
    filt_fft = cv2.dft(MODEL.filt, flags=0, nonzeroRows=256)
    bias_fft = cv2.dft(MODEL.bias, flags=0, nonzeroRows=256)
    resp_fft = cv2.mulSpectrums(filt_fft, hist_fft, flags=0)
    resp_fft = cv2.add(resp_fft, bias_fft)
    resp = cv2.dft(resp_fft, flags=cv2.DFT_INVERSE | cv2.DFT_REAL_OUTPUT, nonzeroRows=256)
    _, _, _, max_loc = cv2.minMaxLoc(resp)
    x, y = max_loc
    Lu = x * ccc.BIN_SIZE + ccc.UV0
    Lv = y * ccc.BIN_SIZE + ccc.UV0
    gain_r, gain_g, gain_b = np.exp(Lu), 1.0, np.exp(Lv)
    factor = min(gain_r, gain_g, gain_b)
    gains = (gain_b / factor, gain_g / factor, gain_r / factor)
    out = cv2.multiply(img, gains + (0,))
    return out, (x, y), hist, resp


@pytest.fixture(scope="module")
def alphasense():
    return cv2.imread("tests/fixtures/alphasense.png")


def test_resize_parity_native_sizes(alphasense):
    ref = cv2.resize(alphasense, (360, 270))
    out = np.asarray(resize_linear_u8(alphasense, 270, 360))
    np.testing.assert_array_equal(out, ref)
    big = cv2.resize(alphasense, (1440, 1080))
    np.testing.assert_array_equal(
        np.asarray(resize_linear_u8(big, 270, 360)), cv2.resize(big, (360, 270))
    )


def test_histogram_parity(alphasense):
    _, _, hist_ref, _ = cv_reference_ccc(alphasense)
    small = np.asarray(resize_linear_u8(alphasense, 270, 360))
    hist = np.asarray(ccc.log_chroma_histogram(small, 0.9, 0.1))
    np.testing.assert_allclose(hist, hist_ref, atol=1e-6)
    # reference quirk: hist sums to (valid pixels)/(all pixels) <= 1
    assert 0.2 < hist.sum() <= 1.0 + 1e-6


def _numpy_counts(small, bright=0.9, dark=0.1):
    """Independent numpy count of the log-chroma histogram: cv2.log of the
    float image (the reference's cv::log), C++ round-half-away bins, one
    np.add.at per valid pixel."""
    f = small.astype(np.float32)
    gray = cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)
    include = (gray <= np.float32(255.0 * bright)) & (gray > np.float32(255.0 * dark))
    logs = cv2.log(f)
    with np.errstate(divide="ignore", invalid="ignore"):
        valid = include & np.isfinite(logs).all(-1)
        uv0, inv_bin = np.float32(ccc.UV0), np.float32(1.0 / ccc.BIN_SIZE)

        def bins(d):
            x = (d - uv0) * inv_bin
            r = np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))
            return np.clip(np.nan_to_num(r), 0, 255).astype(np.int64)

        u = bins(logs[..., 1] - logs[..., 2])
        v = bins(logs[..., 1] - logs[..., 0])
    counts = np.zeros((256, 256), np.int64)
    np.add.at(counts, (u[valid], v[valid]), 1)
    return counts


@pytest.mark.parametrize("fixture", ["alphasense.png", "gehler_shi.png"])
def test_histogram_einsum_matches_numpy_counts(fixture):
    """The one-hot einsum histogram is the exact integer count of a plain
    np.add.at over the same bins, times the reference's 1/(rows*cols)."""
    img = cv2.imread(f"tests/fixtures/{fixture}")
    small = cv2.resize(img, (ccc.SMALL_W, ccc.SMALL_H))
    hist = np.asarray(ccc.log_chroma_histogram(small, 0.9, 0.1))
    n_px = ccc.SMALL_W * ccc.SMALL_H
    counts = np.rint(hist.astype(np.float64) * n_px).astype(np.int64)
    np.testing.assert_array_equal(counts, _numpy_counts(small))
    np.testing.assert_array_equal(
        hist, (counts * np.float32(1.0 / n_px)).astype(np.float32)
    )


def test_response_and_argmax_parity(alphasense):
    _, (x_ref, y_ref), hist_ref, resp_ref = cv_reference_ccc(alphasense)
    resp = np.asarray(
        ccc.ccc_response(hist_ref, MODEL.filt_dft_re, MODEL.filt_dft_im, MODEL.bias)
    )
    # cv2's unnormalized inverse DFT = N * our normalized response; values
    # span ~1e6, and the DFT-by-matmul path agrees to ~1e-6 relative
    n = 256 * 256
    np.testing.assert_allclose(resp * n, resp_ref, rtol=1e-4, atol=2.0)
    uv = np.asarray(ccc.response_argmax(resp[None]))[0]
    assert (uv[0], uv[1]) == (x_ref, y_ref)


@pytest.mark.parametrize("fixture", ["alphasense.png", "gehler_shi.png"])
def test_response_argmax_default_equals_highest(fixture):
    """The chain runs the response matmuls at DEFAULT precision (TF32 on a
    GPU); its argmax must equal the HIGHEST-precision one. On the CPU both
    are true f32, so this pins the code path; chip_smoke.py makes the same
    comparison on the card."""
    img = cv2.imread(f"tests/fixtures/{fixture}")
    small = cv2.resize(img, (ccc.SMALL_W, ccc.SMALL_H))
    batch = np.stack([small, 255 - small, small[:, ::-1]])
    hist = ccc.log_chroma_histogram(batch, 0.9, 0.1)
    args = (hist, MODEL.filt_dft_re, MODEL.filt_dft_im, MODEL.bias)
    got = ccc.response_argmax(ccc.ccc_response(*args))
    want = ccc.response_argmax(
        ccc.ccc_response(*args, precision=jax.lax.Precision.HIGHEST)
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_full_ccc_parity(alphasense):
    ref, (x_ref, y_ref), _, _ = cv_reference_ccc(alphasense)
    out, _ = ccc.ccc_balance_white(alphasense[None], MODEL)
    # bit-exact on the reference fixtures (round 5 tightening; the only
    # theoretical residual is an f32-vs-double ulp in the exp() gains that
    # no fixture or random sweep has ever fired — see PARITY.md)
    np.testing.assert_array_equal(np.asarray(out)[0], ref)


def test_full_ccc_batched(alphasense):
    flipped = alphasense[::-1].copy()
    batch = np.stack([alphasense, flipped])
    out, _ = ccc.ccc_balance_white(batch, MODEL)
    solo0, _ = ccc.ccc_balance_white(alphasense[None], MODEL)
    solo1, _ = ccc.ccc_balance_white(flipped[None], MODEL)
    np.testing.assert_array_equal(np.asarray(out)[0], np.asarray(solo0)[0])
    np.testing.assert_array_equal(np.asarray(out)[1], np.asarray(solo1)[0])


def cv_kalman_sequence(measurements):
    """cv::KalmanFilter(2,2,0) recurrence as configured at ccc.cpp:180-206,
    with the first-frame reset logic of ccc.cpp:300-340."""
    x = np.array([128.0, 128.0], np.float32)
    P = np.zeros((2, 2), np.float32)
    F = np.eye(2, dtype=np.float32)
    Q = np.eye(2, dtype=np.float32)
    R = 10 * np.eye(2, dtype=np.float32)
    first = True
    out = []
    for z in measurements:
        z = np.asarray(z, np.float32)
        if first:
            x = z.copy()
            first = False
        else:
            P1 = F @ P @ F.T + Q
            K = P1 @ np.linalg.inv(P1 + R)
            x = x + K @ (z - x)
            P = (np.eye(2, dtype=np.float32) - K) @ P1
        out.append((int(x[0]), int(x[1])))  # cv::Point float->int truncation
    return out


def test_kalman_matches_cv_recurrence():
    rng = np.random.default_rng(0)
    meas = rng.integers(100, 160, (20, 2))
    ref = cv_kalman_sequence(meas)
    state = ccc.kalman_init(())
    got = []
    for z in meas:
        state, uv = ccc.kalman_update(state, np.asarray(z, np.int32))
        got.append(tuple(np.asarray(uv)))
    assert got == ref


def test_kalman_reset():
    state = ccc.kalman_init(())
    state, uv1 = ccc.kalman_update(state, np.array([10, 20], np.int32))
    assert tuple(np.asarray(uv1)) == (10, 20)
    state, uv2 = ccc.kalman_update(state, np.array([30, 40], np.int32))
    # smoothed: between old and new
    assert 10 < int(np.asarray(uv2)[0]) < 30
    # reset = fresh init (resetTemporalConsistency, ccc.cpp:433-435)
    state = ccc.kalman_init(())
    state, uv3 = ccc.kalman_update(state, np.array([50, 60], np.int32))
    assert tuple(np.asarray(uv3)) == (50, 60)


def test_full_ccc_parity_gehler_shi():
    """Second reference fixture (raw_image_pipeline_white_balance/data)."""
    img = cv2.imread("tests/fixtures/gehler_shi.png")
    assert img is not None
    ref, (x_ref, y_ref), _, _ = cv_reference_ccc(img)
    out, _ = ccc.ccc_balance_white(img[None], MODEL)
    np.testing.assert_array_equal(np.asarray(out)[0], ref)


def test_kalman_scan_matches_sequential():
    """Batched streaming (kalman_scan over T measurements) is bitwise equal
    to T sequential kalman_update dispatches."""
    rng = np.random.default_rng(1)
    meas = rng.integers(80, 180, (17, 2)).astype(np.int32)
    st_seq = ccc.kalman_init(())
    seq_uv = []
    for z in meas:
        st_seq, uv = ccc.kalman_update(st_seq, z)
        seq_uv.append(np.asarray(uv))
    st_scan, scan_uv = ccc.kalman_scan(ccc.kalman_init(()), meas)
    np.testing.assert_array_equal(np.asarray(scan_uv), np.stack(seq_uv))
    np.testing.assert_array_equal(np.asarray(st_scan.x), np.asarray(st_seq.x))
    np.testing.assert_array_equal(np.asarray(st_scan.p), np.asarray(st_seq.p))
    # state carries across scan calls like across updates
    st_scan2, scan_uv2 = ccc.kalman_scan(st_scan, meas[:5] + 7)
    st_ref = st_seq
    for z in meas[:5] + 7:
        st_ref, uv = ccc.kalman_update(st_ref, z)
    np.testing.assert_array_equal(np.asarray(scan_uv2)[-1], np.asarray(uv))
    np.testing.assert_array_equal(np.asarray(st_scan2.x), np.asarray(st_ref.x))


def test_pipeline_sequence_mode_matches_per_frame_dispatch():
    """A temporal_mode="sequence" pipeline over a batch of B frames equals B
    single-frame dispatches sharing one track (the streamed config-3 path)."""
    from raw_image_pipeline_tpu.pipeline import build_pipeline, init_state
    import dataclasses
    from raw_image_pipeline_tpu.config import PipelineConfig

    cfg = PipelineConfig()
    cfg = cfg.replace(
        white_balance=dataclasses.replace(
            cfg.white_balance, enabled=True, method="ccc",
            temporal_consistency=True,
        )
    )
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (6, 64, 96), np.uint8)

    ref_pipe = build_pipeline(cfg, "bayer_gbrg8", frame_hw=(64, 96),
                              with_state=True)
    st = init_state((1,))
    ref_out = []
    for i in range(frames.shape[0]):
        o, st = ref_pipe(frames[i:i + 1], st)
        ref_out.append(np.asarray(o["processed"])[0])

    seq_pipe = build_pipeline(cfg, "bayer_gbrg8", frame_hw=(64, 96),
                              with_state=True, temporal_mode="sequence")
    out, end_state = seq_pipe(frames, init_state(()))
    np.testing.assert_array_equal(np.asarray(out["processed"]), np.stack(ref_out))
    np.testing.assert_allclose(np.asarray(end_state.x), np.asarray(st.x)[0])


def test_ccc_retune_without_recompile(alphasense):
    """The CCC tuning knobs (saturation thresholds, uv0 — the reference
    node's dynamic_reconfigure surface) are RUNTIME parameters: swapping
    them via make_params on an already-built pipeline changes the output
    without a retrace, and matches a freshly built pipeline bit-for-bit."""
    import dataclasses

    from raw_image_pipeline_tpu.config import PipelineConfig
    from raw_image_pipeline_tpu.pipeline import build_pipeline, make_params

    def cfg_with(bright, dark, uv0):
        base = PipelineConfig()
        return PipelineConfig(
            white_balance=dataclasses.replace(
                base.white_balance, enabled=True, method="ccc",
                temporal_consistency=False,
                saturation_bright_thr=bright, saturation_dark_thr=dark,
                ccc_uv0=uv0,
            )
        )

    hw = alphasense.shape[:2]
    c1 = cfg_with(0.8, 0.1, -1.421875)
    c2 = cfg_with(0.95, 0.05, -1.5)
    pipe = build_pipeline(c1, "bgr8", frame_hw=hw)
    out1, _ = pipe(alphasense[None])

    # retune: new params through the SAME traced fn
    p2 = make_params(c2, hw, pipe.ccc_model)
    out2, _ = pipe.fn(p2, alphasense[None], None)
    fresh = build_pipeline(c2, "bgr8", frame_hw=hw)
    ref2, _ = fresh(alphasense[None])
    np.testing.assert_array_equal(
        np.asarray(out2["processed"]), np.asarray(ref2["processed"])
    )
    # the retune actually changed behavior on this fixture
    assert not np.array_equal(
        np.asarray(out1["processed"]), np.asarray(out2["processed"])
    )
    # and the original fn was never retraced
    assert pipe.fn._cache_size() == 1


@pytest.fixture(scope="module")
def all_triples_gray():
    """cv2's f32 BGR2GRAY of every u8 triple, as [b, g, r] index order."""
    i = np.arange(1 << 24, dtype=np.int64)
    img = np.stack([(i >> 16) & 255, (i >> 8) & 255, i & 255], -1)
    img = img.astype(np.float32).reshape(4096, 4096, 3)
    return img, cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)


def test_cv2_gray_is_the_fma_chain(all_triples_gray):
    """cv2's CV_32F BGR2GRAY is fma(r, cr, fma(b, cb, rn(g*cg))) for every
    u8 triple — the formula the mask tables are built from."""
    img, gray = all_triples_gray
    f64, f32 = np.float64, np.float32
    b, g, r = (img[..., k].astype(f64) for k in range(3))
    t = (b * ccc._GRAY_CB + (g * ccc._GRAY_CG).astype(f32)).astype(f32)
    want = (r * ccc._GRAY_CR + t.astype(f64)).astype(f32)
    np.testing.assert_array_equal(want, gray)


@pytest.mark.parametrize("cut", [204.0, 25.5, 229.5, 51.0, 0.0, 255.0])
def test_gray_mask_tables_match_cv2(all_triples_gray, cut):
    """t[b, g] <= thresholds[r] decides cv2's `gray <= cut` exactly for
    every u8 triple."""
    img, gray = all_triples_gray
    px = img.astype(np.int64)
    t = ccc._GRAY_BG[px[..., 0] * 256 + px[..., 1]]
    got = t <= ccc.gray_thresholds(cut)[px[..., 2]]
    np.testing.assert_array_equal(got, gray <= np.float32(cut))


def test_log_table_is_cv2_log():
    """The histogram's u8 log table is exactly cv::log of the float value."""
    x = np.arange(256, dtype=np.float32).reshape(1, -1)
    np.testing.assert_array_equal(ccc._LOG_U8, cv2.log(x).ravel())
