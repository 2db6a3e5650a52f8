"""Fisheye (equidistant) undistortion.

Init-time host math — bit-exact numpy ports (verified equal to cv2.fisheye
to the last double) of:
  * cv::fisheye::undistortPoints (iterative theta solve),
  * cv::fisheye::estimateNewCameraMatrixForUndistortRectify
    (reference: modules/undistortion.cpp:199-214),
  * cv::fisheye::initUndistortRectifyMap
    (reference: modules/undistortion.cpp:216-238).

Device remap — bilinear gather with BORDER_CONSTANT=0, replicating
cv::remap's u8 arithmetic bit-for-bit in BOTH of its build-dependent
forms (round 5; see remap_precompute): "lerp" (default — the x86/IPP
fma-lerp path of this repo's cv2 5.0 oracle) and "fixed32" (the non-IPP
INTER_BITS=5 integer path of ARM/Jetson builds — the reference's actual
deployment hardware). A quantization-free "float" mode remains
selectable. The reference applies the remap per frame
(undistortion.cpp:240-245).

The maps are computed once per calibration and closed over as constants;
the per-frame device work is 2 chunked row-gathers + the bilinear blend.
The gathers are the one genuinely memory-irregular op in the ISP. Their
packing and chunking (DEFAULT_REMAP_TUNING below) were tuned on an earlier
accelerator and have not been re-derived on the H100.

Like the reference, the fisheye model is used for any distortion_model
string except "none" (undistortion.cpp:199-220, SURVEY.md §8.8).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from raw_image_pipeline_tpu.ops.common import round_u8, seal_f32


# ---------------------------------------------------------------------------
# Host-side fisheye math (numpy, float64 — init time only)
# ---------------------------------------------------------------------------


def fisheye_undistort_points(pts: np.ndarray, K: np.ndarray, D: np.ndarray, R: np.ndarray) -> np.ndarray:
    """cv::fisheye::undistortPoints: pts [N,2] pixel coords -> normalized,
    rectified image coords [N,2]."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    R = np.asarray(R, np.float64)
    out = np.empty_like(pts, dtype=np.float64)
    for n, (u, v) in enumerate(np.asarray(pts, dtype=np.float64)):
        pwx, pwy = (u - cx) / fx, (v - cy) / fy
        theta_d = np.sqrt(pwx * pwx + pwy * pwy)
        theta_d = min(max(-np.pi / 2, theta_d), np.pi / 2)
        converged = False
        theta = theta_d
        scale = 0.0
        if abs(theta_d) > 1e-8:
            # Newton solve, op-for-op the library's: the k_i*theta^2i
            # products are formed ONCE and the derivative uses 3*(k0*t2)
            # etc. — (3*k0)*t2 rounds differently at the last ulp
            # (random-intrinsics fuzz, round 5)
            for _ in range(10):
                t2 = theta * theta
                t4, t6, t8 = t2 * t2, t2 * t2 * t2, t2 * t2 * t2 * t2
                k0t2, k1t4, k2t6, k3t8 = D[0] * t2, D[1] * t4, D[2] * t6, D[3] * t8
                fix = (theta * (1 + k0t2 + k1t4 + k2t6 + k3t8) - theta_d) / (
                    1 + 3 * k0t2 + 5 * k1t4 + 7 * k2t6 + 9 * k3t8
                )
                theta -= fix
                if abs(fix) < 1e-8:
                    converged = True
                    break
            # math.tan == libm tan == the library's std::tan; numpy's own
            # SIMD f64 tan is 1 ulp off at some arguments (seed-95 fuzz)
            scale = math.tan(theta) / theta_d
        else:
            converged = True
            scale = 1.0
        # theta is monotonic in theta_d: a sign flip means divergence
        theta_flipped = (theta_d < 0 < theta) or (theta_d > 0 > theta)
        if converged and not theta_flipped:
            pux, puy = pwx * scale, pwy * scale
            # plain left-associated 3x3 matvec (Matx33d*Vec3d), not numpy
            # dot — BLAS fma/pairwise sums can differ in the last ulp
            pr = [R[i, 0] * pux + R[i, 1] * puy + R[i, 2] for i in range(3)]
            out[n] = (pr[0] / pr[2], pr[1] / pr[2])
        else:
            # the library marks non-converged points with this sentinel;
            # estimateNewCameraMatrix... then consumes it as-is, which is
            # why wildly-distorted calibrations yield degenerate newK
            out[n] = (-1000000.0, -1000000.0)
    return out


def estimate_new_camera_matrix(
    K: np.ndarray,
    D: np.ndarray,
    image_size: Tuple[int, int],
    R: np.ndarray,
    balance: float = 0.0,
    new_size: Tuple[int, int] | None = None,
    fov_scale: float = 1.0,
) -> np.ndarray:
    """cv::fisheye::estimateNewCameraMatrixForUndistortRectify.
    image_size/new_size are (width, height)."""
    w, h = image_size
    balance = min(max(balance, 0.0), 1.0)
    # the C++ boundary sample points use INTEGER division for the
    # midpoints (int width/height, fisheye.cpp) — visible at ODD sizes,
    # where float halves shift newK by ~0.3 px (round-5 finding, verified
    # equal to cv2 at odd sizes only with the integer halves)
    pts = np.array(
        [[w // 2, 0], [w, h // 2], [w // 2, h], [0, h // 2]], np.float64
    )
    up = fisheye_undistort_points(pts, K, D, R)
    cn = up.mean(axis=0)
    aspect = K[0, 0] / K[1, 1]
    cn[1] *= aspect
    up = up.copy()
    up[:, 1] *= aspect
    minx, miny = up.min(axis=0)
    maxx, maxy = up.max(axis=0)
    f1 = w * 0.5 / (cn[0] - minx)
    f2 = w * 0.5 / (maxx - cn[0])
    f3 = h * 0.5 * aspect / (cn[1] - miny)
    f4 = h * 0.5 * aspect / (maxy - cn[1])
    fmin, fmax = min(f1, f2, f3, f4), max(f1, f2, f3, f4)
    f = balance * fmin + (1.0 - balance) * fmax
    f *= (1.0 / fov_scale) if fov_scale > 0 else 1.0
    new_f = [f, f]
    new_c = [-cn[0] * f + w * 0.5, -cn[1] * f + h * aspect * 0.5]
    new_f[1] /= aspect
    new_c[1] /= aspect
    if new_size is not None:
        rx, ry = new_size[0] / w, new_size[1] / h
        new_f[0] *= rx
        new_f[1] *= ry
        new_c[0] *= rx
        new_c[1] *= ry
    return np.array(
        [[new_f[0], 0, new_c[0]], [0, new_f[1], new_c[1]], [0, 0, 1]], np.float64
    )


def _inv3_cv(a: np.ndarray) -> np.ndarray:
    """3x3 inverse, op-for-op cv::Matx_FastInvOp<double,3> (DECOMP_LU):
    cofactor-expansion determinant, d = 1/det, each adjugate entry formed
    as (m1*m2 - m3*m4) * d. Verified bitwise == cv2.invert(DECOMP_LU) on
    2000 random matrices."""
    a = np.asarray(a, np.float64)
    det = (
        a[0, 0] * (a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1])
        - a[0, 1] * (a[1, 0] * a[2, 2] - a[1, 2] * a[2, 0])
        + a[0, 2] * (a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0])
    )
    d = 1.0 / det
    b = np.empty((3, 3), np.float64)
    b[0, 0] = (a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1]) * d
    b[0, 1] = (a[0, 2] * a[2, 1] - a[0, 1] * a[2, 2]) * d
    b[0, 2] = (a[0, 1] * a[1, 2] - a[0, 2] * a[1, 1]) * d
    b[1, 0] = (a[1, 2] * a[2, 0] - a[1, 0] * a[2, 2]) * d
    b[1, 1] = (a[0, 0] * a[2, 2] - a[0, 2] * a[2, 0]) * d
    b[1, 2] = (a[0, 2] * a[1, 0] - a[0, 0] * a[1, 2]) * d
    b[2, 0] = (a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]) * d
    b[2, 1] = (a[0, 1] * a[2, 0] - a[0, 0] * a[2, 1]) * d
    b[2, 2] = (a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]) * d
    return b


def init_undistort_rectify_map(
    K: np.ndarray,
    D: np.ndarray,
    R: np.ndarray,
    P: np.ndarray,
    size: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray]:
    """cv::fisheye::initUndistortRectifyMap -> (map_x, map_y) float32 [H, W].
    size is (width, height); P may be 3x3 or 3x4 (only P[:3,:3] is used)."""
    w, h = size
    # plain left-associated 3x3 matmul + the library's closed-form
    # adjugate inverse (cv::Matx_FastInvOp<double,3>, DECOMP_LU) — BLAS
    # matmul order and LAPACK LU both differ from it in the last f64
    # ulp, which flips f32 map values at catastrophic-cancellation
    # pixels (~1 px per 400 random-intrinsics frames; round-5 fuzz,
    # discriminated LU-vs-SVD empirically over 400 seeds: LU matches)
    Pm, Rm = np.asarray(P, np.float64)[:3, :3], np.asarray(R, np.float64)
    PR = np.empty((3, 3), np.float64)
    for i in range(3):
        for j in range(3):
            PR[i, j] = Pm[i, 0] * Rm[0, j] + Pm[i, 1] * Rm[1, j] + Pm[i, 2] * Rm[2, j]
    iR = _inv3_cv(PR)

    # cv2 walks each row INCREMENTALLY (_x starts at i*iR01 + iR02 and
    # accumulates += iR00 per column, fisheye.cpp) — the running-sum
    # rounding differs from the closed form j*iR00 + i*iR01 + iR02 at
    # ~.5-ulp boundaries (one f32 map ulp flipped on a real-D 720x540
    # sweep; round-5 finding). np.add.accumulate is the same ordered scan.
    rows = np.arange(h, dtype=np.float64)[:, None]

    def scan_row(r0):
        steps = np.full((h, w), iR[r0, 0])
        steps[:, 0:1] = rows * iR[r0, 1] + iR[r0, 2]
        return np.add.accumulate(steps, axis=1)

    _x = scan_row(0)
    _y = scan_row(1)
    _w = scan_row(2)
    x = _x / _w
    y = _y / _w
    r = np.sqrt(x * x + y * y)
    # elementwise libm atan (= the library's std::atan): numpy's SIMD f64
    # arctan is 1 ulp off at ~0.15% of arguments (round-5 probe), a latent
    # f32 flip at cancellation pixels; ~0.23 s/Mpx, init-time only
    theta = np.frompyfunc(math.atan, 1, 1)(r).astype(np.float64)
    # the power chain must match cv2's double arithmetic op-for-op
    # (theta6 = theta4*theta2 etc. — np.power(t2, 3) rounds differently
    # at ~1-ulp boundaries; round-5 finding on synthetic intrinsics)
    t2 = theta * theta
    t4 = t2 * t2
    t6 = t4 * t2
    t8 = t4 * t4
    theta_d = theta * (1 + D[0] * t2 + D[1] * t4 + D[2] * t6 + D[3] * t8)
    with np.errstate(invalid="ignore", divide="ignore"):
        scale = np.where(r == 0, 1.0, theta_d / np.where(r == 0, 1.0, r))
    u = K[0, 0] * x * scale + K[0, 2]
    v = K[1, 1] * y * scale + K[1, 2]
    return u.astype(np.float32), v.astype(np.float32)


# ---------------------------------------------------------------------------
# Device remap
# ---------------------------------------------------------------------------


_INTER_BITS = 5
_INTER_TAB_SIZE = 1 << _INTER_BITS  # 32
_REMAP_COEF_BITS = 15
_REMAP_COEF_SCALE = 1 << _REMAP_COEF_BITS  # 32768


def _bilinear_fixed_wtab() -> np.ndarray:
    """cv::remap's 32x32 fixed-point bilinear weight table (initInterTab2D
    semantics, reverse-engineered and verified entry-for-entry against a
    live cv2 5.0 via u16 probe remaps): per fractional cell (ay, ax) the
    four f32 tap products are rounded to 2^15 scale and the rounding
    residual is subtracted from the LARGEST entry so every row sums to
    exactly 2^15. Returns [32, 32, 4] int32 (tap order 00,01,10,11)."""
    f32 = np.float32
    t = np.zeros((_INTER_TAB_SIZE, _INTER_TAB_SIZE, 4), np.int32)
    for ay in range(_INTER_TAB_SIZE):
        for ax in range(_INTER_TAB_SIZE):
            fy = f32(ay) / f32(_INTER_TAB_SIZE)
            fx = f32(ax) / f32(_INTER_TAB_SIZE)
            vals = np.array(
                [(1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx],
                f32,
            )
            it = np.rint(vals.astype(np.float64) * _REMAP_COEF_SCALE).astype(np.int64)
            diff = it.sum() - _REMAP_COEF_SCALE
            if diff:
                it[np.argmax(it)] -= diff
            t[ay, ax] = it
    return t


def remap_precompute(
    map_x: np.ndarray, map_y: np.ndarray, src_hw: Tuple[int, int],
    mode: str = "lerp",
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side (init-time) factorization of the remap into one gather
    index plus four masked bilinear weights per output pixel.

    OpenCV's remap has two build-dependent u8 arithmetics, and BOTH are
    replicated bit-for-bit (the reference's output depends on which
    OpenCV it links):

    mode="lerp" (default — matches THIS repo's cv2 5.0 x86/IPP oracle,
    verified 0 mismatches over millions of fisheye-map pixels): per pixel
    two x-lerps and one y-lerp, each a SINGLE-ROUNDING fused multiply-add
    in f32 — t = fma(fx, v01-v00, v00), b = fma(fx, v11-v10, v10),
    out = rint(fma(fy, b-t, t)) — with out-of-image taps reading 0
    (BORDER_CONSTANT). Device fmas are Dekker-emulated (ops/common.fma_f32).
    Returns weights [6, N] = (fx, fy, mask00, mask01, mask10, mask11) and
    base rows with the pack's zero margin already applied (taps sit at
    their NATURAL slots; masks kill row-wraparound garbage at borders).

    mode="fixed32" (OpenCV's non-IPP path — ARM/Jetson builds, and any
    build fed pre-converted CV_16SC2 maps; verified 0 mismatches against
    cv2.convertMaps + remap): coordinates snapped to 1/32 px
    (sx = rint(f32(map)*32), anchor sx>>5, frac sx&31), weights from the
    2^15-scaled integer table (_bilinear_fixed_wtab), blended as exact
    integers with the final (sum + 2^14) >> 15. Every intermediate is an
    exact integer in f32 (products <= 255*2^15, 4-sums + 2^14 < 2^25), so
    this blend is immune to fma contraction by construction.

    mode="float" is the rounds-1-4 formulation: true f32 fractional
    per-slot weights, sealed two-rounding product blend, round-half-even —
    a quantization-free variant kept selectable for comparison (differs
    from the IPP lerp at ~4 per million pixels).

    fixed32/float fetch window: the 2x2 block anchored at
    base = (clip(iy,0,H-2), clip(ix,0,W-2)); the weights are assigned to
    the four *fetched* positions, with any tap falling outside the image
    contributing exactly 0 (= cv::remap BORDER_CONSTANT 0). Clipping only
    ever moves the anchor when the true tap is out of range, and the
    weight bookkeeping keeps the in-range taps on their fetched slots, so
    the result is identical to the padded-image formulation (bit-exact vs
    cv2, see tests/test_undistortion.py) without materializing a padded
    copy per call.

    Returns (base [N] int32 flat row-major gather indices,
             weights [4, N] f32 per-slot weights for offsets
             {0, +1, +W, +W+1} - integer-valued 2^15-scale in fixed32
             mode; [6, N] (fx, fy, 4 tap masks) in lerp mode).
    """
    h, w = src_hw
    f32 = np.float32
    mx = np.asarray(map_x)
    my = np.asarray(map_y)
    if not (np.isfinite(mx).all() and np.isfinite(my).all()):
        # fail loudly at init: a NaN here would otherwise flow into the
        # blend weights and flip seal_f32's runtime zero at run time,
        # silently perturbing every sealed product in the frame
        raise ValueError("undistortion maps contain non-finite values")
    if mode == "lerp":
        m = w + 1  # pack margin (see _remap_rows lerp pack)
        X = mx.astype(f32)
        Y = my.astype(f32)
        ix = np.floor(X).astype(np.int64)
        iy = np.floor(Y).astype(np.int64)
        fx = (X - ix.astype(f32)).astype(f32)
        fy = (Y - iy.astype(f32)).astype(f32)
        masks = [
            (((iy + dy >= 0) & (iy + dy <= h - 1)
              & (ix + dx >= 0) & (ix + dx <= w - 1)).astype(f32))
            for dy in (0, 1) for dx in (0, 1)
        ]
        weights = np.stack(
            [fx, fy] + masks
        ).reshape(6, -1).astype(f32)
        flat = iy * w + ix
        # any-tap-in-range pixels satisfy flat in [-m, h*w - 1] by
        # construction; fully-out pixels all point at the pack's zero
        # margin row 0 (one cached row — same trick as the other modes)
        any_in = (np.stack(masks).sum(axis=0) > 0).reshape(-1)
        flat = np.clip(flat.reshape(-1), -m, h * w - 1)
        base = np.where(any_in, flat + m, 0).astype(np.int32)
        return base, weights
    if mode == "fixed32":
        # clip in float before the int cast: a pathological map value
        # near f32 max would otherwise overflow the int64 conversion
        # (cv2 saturates its XY shorts similarly; such pixels are fully
        # out-of-image either way)
        sx = np.rint(np.clip(
            (mx.astype(f32) * f32(_INTER_TAB_SIZE)).astype(f32),
            -2.0**40, 2.0**40)).astype(np.int64)
        sy = np.rint(np.clip(
            (my.astype(f32) * f32(_INTER_TAB_SIZE)).astype(f32),
            -2.0**40, 2.0**40)).astype(np.int64)
        ix = sx >> _INTER_BITS
        iy = sy >> _INTER_BITS
        w4 = _bilinear_fixed_wtab()[
            sy & (_INTER_TAB_SIZE - 1), sx & (_INTER_TAB_SIZE - 1)
        ]  # [..., 4] int32 tap weights (00,01,10,11)

        bx = np.clip(ix, 0, w - 2)
        by = np.clip(iy, 0, h - 2)
        # assign each IN-RANGE true tap's integer weight to its fetched
        # slot (clipping only moves the anchor when a tap is out of range,
        # so in-range taps always land on slot 0/1 per axis)
        slots = np.zeros((4,) + ix.shape, np.int64)
        for ty in (0, 1):
            for tx in (0, 1):
                wt = w4[..., ty * 2 + tx]
                inb = ((iy + ty >= 0) & (iy + ty <= h - 1)
                       & (ix + tx >= 0) & (ix + tx <= w - 1))
                dy = iy + ty - by
                dx = ix + tx - bx
                for sdy in (0, 1):
                    for sdx in (0, 1):
                        hit = inb & (dy == sdy) & (dx == sdx)
                        slots[sdy * 2 + sdx] += np.where(hit, wt, 0)
        weights = slots.reshape(4, -1).astype(f32)
    elif mode == "float":
        ix = np.floor(mx).astype(np.int64)
        iy = np.floor(my).astype(np.int64)
        fx = mx.astype(f32) - ix.astype(f32)
        fy = my.astype(f32) - iy.astype(f32)

        bx = np.clip(ix, 0, w - 2)
        by = np.clip(iy, 0, h - 2)

        def axis_weights(i, f, b, n):
            # weight carried by fetched positions b and b+1 along one axis
            in0 = (i >= 0) & (i <= n - 1)
            in1 = (i + 1 >= 0) & (i + 1 <= n - 1)
            w_lo = (1 - f) * in0  # tap at i
            w_hi = f * in1  # tap at i+1
            pos0 = w_lo * (i == b) + w_hi * (i + 1 == b)
            pos1 = w_lo * (i == b + 1) + w_hi * (i + 1 == b + 1)
            return pos0.astype(f32), pos1.astype(f32)

        wx0, wx1 = axis_weights(ix, fx, bx, w)
        wy0, wy1 = axis_weights(iy, fy, by, h)
        weights = np.stack(
            [wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1]
        ).reshape(4, -1).astype(f32)
    else:
        raise ValueError(f"unknown remap mode [{mode}]")
    base = (by * w + bx).reshape(-1).astype(np.int32)
    # fully out-of-image output pixels (all four weights zero — ~10% of a
    # fisheye undistortion's corners) still spend gather indices; pointing
    # them all at row 0 instead of their scattered clamped positions lets
    # the gather hit one cached row (bit-identical output)
    base[(weights == 0).all(axis=0)] = 0
    return base, weights


# Default gather tuning (slots, chunk): 2-slot pack with paired gathers,
# 130k-index chunks — scan-tuned for the single-camera chain at 1080p B=64
# on an earlier accelerator (see _remap_rows); not re-derived on the H100.
# Multi-camera remaps use the camera-blocked form (n_cameras > 1 below)
# rather than a vmapped gather: per-camera packs row-concatenated into one
# buffer and the per-camera indices offset into it — one flat chunked
# gather.
DEFAULT_REMAP_TUNING = (2, 130_000)

# Trace-time tuning resolution (tuning=None in the wrappers): the 2-slot
# pack halves the pack write at the cost of DOUBLING gather indices — the
# trade chosen for throughput batches; a single frame, where the gather
# is index-bound, takes the 4-slot one-gather form instead. The 4-slot
# form engages only when the flattened source has <=
# LATENCY_TUNING_MAX_COLS columns (batch*channels — i.e. a single color
# frame); everything wider keeps the throughput default. Both forms are
# bit-identical; the split point is not measured on the H100.
LATENCY_REMAP_TUNING = (4, 2_100_000)
LATENCY_TUNING_MAX_COLS = 4


def _resolve_tuning(tuning, n_cols: int) -> Tuple[int, int]:
    if tuning is not None:
        return tuning
    if n_cols <= LATENCY_TUNING_MAX_COLS:
        return LATENCY_REMAP_TUNING
    return DEFAULT_REMAP_TUNING

def _remap_rows(arrs, base: jax.Array, weights: jax.Array,
                h: int, w: int,
                tuning: Tuple[int, int] | None = None,
                mode: str = "lerp") -> jax.Array:
    """Shared gather/blend core.

    arrs: list of per-camera [H*W, K] u8 sources (any K-column ordering;
    weights broadcast over K). base/weights: flat [N] / [4, N] when one
    camera, stacked [C, N] / [C, 4, N] when len(arrs) == C > 1 (row
    indices are per-camera-local; the camera block offsets are applied
    here). Returns [C*N, K] u8 rows, camera-major.

    tuning = (slots, chunk_size): slots=2 packs row i as the horizontal
    pair [arr[i], arr[i+1]] and fetches the vertical pair with a SECOND
    gather at base + W — half the pack write (12.5 vs 25 MB/frame) for 2x
    gather indices. slots=4 packs all four taps in one row and spends one
    index per output pixel. Both are bit-identical per pixel.
    """
    f32 = jnp.float32
    k = arrs[0].shape[1]
    slots, chunk_size = _resolve_tuning(tuning, k)

    # The pack is overlapping slices of ONE zero-padded buffer (rolls
    # lower to wrap-around copies; pad+slice is a straight strided copy);
    # slots of the last pixels land in the zero pad rows and out-of-image
    # taps carry zero weight by construction.
    def make_pack(arr):
        if mode == "lerp":
            # margin-padded pack: base indices from remap_precompute carry
            # a +`m` offset so every tap reads its NATURAL flat position
            # (border row-wraparound garbage is zeroed by the per-tap
            # masks); leading margin row 0 is the all-out-of-image row
            m = w + 1
            r = h * w + 2 * m
            if slots == 2:
                arrp = jnp.pad(arr, ((m, m + 1), (0, 0)))
                return jnp.concatenate([arrp[:r], arrp[1:r + 1]], axis=1)
            arrp = jnp.pad(arr, ((m, m + w + 1), (0, 0)))
            return jnp.concatenate(
                [arrp[:r], arrp[1:r + 1], arrp[w:r + w],
                 arrp[w + 1:r + w + 1]],
                axis=1,
            )
        if slots == 2:
            arrp = jnp.pad(arr, ((0, 1), (0, 0)))
            p = jnp.concatenate([arrp[: h * w], arrp[1 : h * w + 1]], axis=1)
            # base is anchor-clipped to row <= h-2 so base + w stays in
            # range; the extra w zero rows are cheap insurance for
            # degenerate calibrations
            return jnp.pad(p, ((0, w), (0, 0)))  # [H*W + W, 2K]
        arrp = jnp.pad(arr, ((0, w + 1), (0, 0)))
        return jnp.concatenate(
            [
                arrp[: h * w],
                arrp[1 : h * w + 1],
                arrp[w : h * w + w],
                arrp[w + 1 : h * w + w + 1],
            ],
            axis=1,
        )  # [H*W, 4K]

    packs = [make_pack(a) for a in arrs]
    block = packs[0].shape[0]  # rows per camera block
    packed = packs[0] if len(packs) == 1 else jnp.concatenate(packs, axis=0)
    if len(arrs) > 1:
        # per-camera-local row indices -> global rows in the concatenated
        # pack; weights flatten camera-major to match the output rows
        offs = (jnp.arange(len(arrs), dtype=base.dtype) * block)[:, None]
        base = (base + offs).reshape(-1)
        nw = weights.shape[1]  # 4 weight rows (float/fixed32) or 6 (lerp)
        weights = jnp.moveaxis(weights, 1, 0).reshape(nw, -1)
    # materialize the pack exactly once: without the barrier XLA may
    # re-fuse the pack construction into each chunk's gather operand and
    # rebuild it per chunk
    packed = jax.lax.optimization_barrier(packed)

    # chunk the output so every single gather stays at a bounded index
    # count; the blend fuses into each gather's consumer and only the
    # small u8 results concatenate.
    n = int(base.shape[0])
    n_chunks = max(1, -(-n // chunk_size))
    chunk = -(-n // n_chunks)
    # runtime zero for the blend seal (weights are finite by construction)
    rt_zero = (weights[0, 0] != weights[0, 0]).astype(jnp.int32)
    outs = []
    for s in range(n_chunks):
        sl = slice(s * chunk, min((s + 1) * chunk, n))
        bs = base[sl]
        # tap groups as column slices (a [N,slots,K] reshape gets a
        # tile-padded layout); blend in f32, round to u8 before the output
        # transpose so the transposed temp is 4x smaller
        if slots == 2:
            top = jnp.take(packed, bs, axis=0)  # [Nc, 2K] u8
            bot = jnp.take(packed, bs + w, axis=0)  # [Nc, 2K] u8
            taps = (top[:, 0:k], top[:, k:2 * k],
                    bot[:, 0:k], bot[:, k:2 * k])
        else:
            rows = jnp.take(packed, bs, axis=0)  # [Nc, 4K] u8
            taps = tuple(rows[:, i * k:(i + 1) * k] for i in range(4))
        if mode == "lerp":
            # cv2 5.0 x86/IPP arithmetic: two x-lerps + one y-lerp, each a
            # single-rounding fma; masks zero the out-of-image taps (and
            # any border wraparound garbage). The x-lerps use a LEAN exact
            # fma: their second operand (v1-v0) and addend (v0) are exact
            # small integers, so Dekker's 2Product needs no operand-b
            # split, and the fx split is shared between the two lerps
            # (verified == the f64-oracle fma over 16M samples incl.
            # adversarial tiny fx; the y-lerp's operands are generic f32,
            # so it keeps the full fma_f32 emulation).
            from raw_image_pipeline_tpu.ops.common import fma_f32

            fx = weights[0][sl, None]
            fy = weights[1][sl, None]
            v00 = taps[0].astype(f32) * weights[2][sl, None]
            v01 = taps[1].astype(f32) * weights[3][sl, None]
            v10 = taps[2].astype(f32) * weights[4][sl, None]
            v11 = taps[3].astype(f32) * weights[5][sl, None]
            C = f32(4097.0)  # Dekker split constant (2^12 + 1)
            ca = fx * C
            fxh = ca - (ca - fx)
            fxl = fx - fxh

            def lerp_x(v0, v1):
                d = v1 - v0  # exact integer, |d| <= 255
                pp = fx * d
                err = (fxh * d - pp) + fxl * d
                ss = pp + v0
                bb = ss - pp
                e2 = (pp - (ss - bb)) + (v0 - bb)
                return ss + (e2 + err)

            t = lerp_x(v00, v01)
            b = lerp_x(v10, v11)
            outs.append(round_u8(fma_f32(fy, b - t, t)))
            continue
        if mode == "fixed32":
            # cv::remap's integer blend: 2^15-scaled integer weights, all
            # intermediates exact integers in f32 (products <= 255*2^15,
            # sum + 2^14 < 2^25), final truncating shift — exact under ANY
            # fma contraction/reassociation, so no sealing is needed
            acc = (
                taps[0].astype(f32) * weights[0][sl, None]
                + taps[1].astype(f32) * weights[1][sl, None]
                + taps[2].astype(f32) * weights[2][sl, None]
                + taps[3].astype(f32) * weights[3][sl, None]
            )
            v = jnp.floor(
                (acc + f32(1 << (_REMAP_COEF_BITS - 1)))
                * f32(1.0 / _REMAP_COEF_SCALE)
            )
            outs.append(jnp.clip(v, 0, 255).astype(jnp.uint8))
            continue
        # float mode: each product sealed against fma contraction so the
        # plain left-associative two-rounding chain holds identically in
        # every program variant (the GSPMD-partitioned blend measurably
        # diverged from the unpartitioned one on CPU without this; see
        # seal_f32)
        acc = (
            seal_f32(taps[0].astype(f32) * weights[0][sl, None], rt_zero)
            + seal_f32(taps[1].astype(f32) * weights[1][sl, None], rt_zero)
            + seal_f32(taps[2].astype(f32) * weights[2][sl, None], rt_zero)
            + seal_f32(taps[3].astype(f32) * weights[3][sl, None], rt_zero)
        )
        outs.append(round_u8(acc))
    return outs[0] if n_chunks == 1 else jnp.concatenate(outs, axis=0)


@partial(jax.jit, static_argnames=("out_hw", "src_hw", "batch_minor",
                                   "tuning", "n_cameras", "mode"))
def remap_bilinear_u8(
    image: jax.Array, base: jax.Array, weights: jax.Array,
    out_hw: Tuple[int, int],
    src_hw: Tuple[int, int] | None = None,
    batch_minor: bool = False,
    tuning: Tuple[int, int] | None = None,
    n_cameras: int = 1,
    mode: str = "lerp",
) -> jax.Array:
    """cv::remap(INTER_LINEAR, BORDER_CONSTANT, 0) with precomputed
    (base, weights) from remap_precompute.

    image: [..., H, W, C] uint8 -> [..., Ho, Wo, C] uint8, or with
    batch_minor=True [H, W, ..., C] -> [Ho, Wo, ..., C] (the pipeline's
    internal layout: spatial-major means the flatten below needs no
    transposes at all).

    Formulation: the gather's cost is dominated by its index count, not
    by the bytes each index fetches, so the kernel spends ONE
    index per output pixel: the image is flattened to [H*W, batch*C] and
    the four bilinear taps pre-packed into one wide row — a single
    row-gather fetches all taps for every frame and channel at once, and
    per-frame gather cost scales as 1/batch.
    """
    if batch_minor:
        h, w = image.shape[0], image.shape[1]
    else:
        h, w = image.shape[-3], image.shape[-2]
    if src_hw is not None and (h, w) != tuple(src_hw):
        # base/weights are precomputed against a specific source size; a
        # different frame would flatten with the wrong row stride and
        # silently produce scrambled output
        raise ValueError(
            f"remap precomputed for source {tuple(src_hw)} but got frame "
            f"({h}, {w}); rebuild the pipeline for this frame size"
        )
    c = image.shape[-1]
    ho, wo = out_hw
    f32 = jnp.float32

    if n_cameras > 1:
        # camera-blocked form (see remap_bilinear_u8_planes): batch axis is
        # camera-major, base/weights stacked [n_cameras, ...]
        if batch_minor:
            bc = image.shape[2] // n_cameras
            arrs = [
                image[:, :, cam * bc:(cam + 1) * bc, :].reshape(h * w, bc * c)
                for cam in range(n_cameras)
            ]
            out_u8 = _remap_rows(arrs, base, weights, h, w, tuning, mode)
            return out_u8.reshape((n_cameras, ho, wo, bc, c))
        bc = image.shape[0] // n_cameras
        arrs = [
            jnp.moveaxis(
                image[cam * bc:(cam + 1) * bc].reshape(bc, h * w, c), 0, 1
            ).reshape(h * w, bc * c)
            for cam in range(n_cameras)
        ]
        out_u8 = _remap_rows(arrs, base, weights, h, w, tuning, mode)
        out = jnp.moveaxis(out_u8.reshape(n_cameras, ho * wo, bc, c), 2, 1)
        return out.reshape(n_cameras * bc, ho, wo, c)

    if batch_minor:
        lead = image.shape[2:-1]
        arr = image.reshape(h * w, -1)
    else:
        lead = image.shape[:-3]
        arr = image.reshape((-1, h * w, c))
        arr = jnp.moveaxis(arr, 0, 1).reshape(h * w, -1)
    out_u8 = _remap_rows([arr], base, weights, h, w, tuning, mode)

    if batch_minor:
        return out_u8.reshape((ho, wo) + lead + (c,))
    out = out_u8.reshape(ho * wo, -1, c)
    out = jnp.moveaxis(out, 1, 0).reshape(lead + (ho, wo, c))
    return out


@partial(jax.jit, static_argnames=("out_hw", "src_hw", "tuning", "n_cameras",
                                   "mode"))
def remap_bilinear_u8_planes(
    planes, base: jax.Array, weights: jax.Array,
    out_hw: Tuple[int, int],
    src_hw: Tuple[int, int] | None = None,
    tuning: Tuple[int, int] | None = None,
    n_cameras: int = 1,
    mode: str = "lerp",
):
    """Planar batch-minor remap: tuple of [H, W, B] u8 planes ->
    [Ho, Wo, C, B] u8 (channel-blocked — planes stay contiguous; the
    caller's final NHWC move is one transpose, same as the packed path).

    Identical gather/blend arithmetic to remap_bilinear_u8; the only
    difference is the K-column ordering of the flattened source
    ([c-block][b] instead of [b-block][c]), which the weights broadcast
    over unchanged — bit-identical per pixel.

    n_cameras > 1 is the camera-blocked multi-calibration form: the B axis
    is camera-major ([n_cameras, B'] flattened), base/weights are stacked
    [n_cameras, N] / [n_cameras, 4, N] (per-camera maps), and the result is
    [n_cameras, Ho, Wo, C, B'] — each camera's block remapped through its
    own map by ONE flat chunked gather over a row-concatenated pack (see
    _remap_rows; never vmap this gather)."""
    h, w = planes[0].shape[0], planes[0].shape[1]
    if src_hw is not None and (h, w) != tuple(src_hw):
        raise ValueError(
            f"remap precomputed for source {tuple(src_hw)} but got frame "
            f"({h}, {w}); rebuild the pipeline for this frame size"
        )
    ho, wo = out_hw
    c = len(planes)
    # barrier: without it XLA's layout assignment propagates the pack
    # concat's layout preferences back through the whole planar pointwise
    # stretch (measured as a ~2x whole-chain regression)
    planes = jax.lax.optimization_barrier(tuple(planes))
    if n_cameras == 1:
        arr = jnp.concatenate([p.reshape(h * w, -1) for p in planes], axis=1)
        out_u8 = _remap_rows([arr], base, weights, h, w, tuning, mode)
        lead = planes[0].shape[2:]
        return out_u8.reshape((ho, wo, c) + lead)
    # camera-major B axis: camera cam's columns are the cam-th B' block of
    # each channel plane
    bc = planes[0].shape[2] // n_cameras  # per-camera batch
    arrs = [
        jnp.concatenate(
            [p[:, :, cam * bc:(cam + 1) * bc].reshape(h * w, bc)
             for p in planes],
            axis=1,
        )
        for cam in range(n_cameras)
    ]
    out_u8 = _remap_rows(arrs, base, weights, h, w, tuning, mode)  # [C*N, c*bc]
    return out_u8.reshape((n_cameras, ho, wo, c, bc))


def remap_bilinear_u8_from_maps(
    image: jax.Array, map_x: np.ndarray, map_y: np.ndarray,
    mode: str = "lerp",
) -> jax.Array:
    """Convenience wrapper taking raw cv2-style float32 maps (host arrays);
    precomputes (base, weights) on the host per call — prefer
    remap_precompute + remap_bilinear_u8 for repeated use. mode selects
    the interpolation arithmetic (see remap_precompute)."""
    h, w = image.shape[-3], image.shape[-2]
    base, weights = remap_precompute(
        np.asarray(map_x), np.asarray(map_y), (h, w), mode=mode
    )
    return remap_bilinear_u8(
        image, jnp.asarray(base), jnp.asarray(weights),
        np.asarray(map_x).shape, mode=mode,
    )
