"""FFCC convolutional color constancy white balance.

JAX implementation of the reference CCC library
(raw_image_pipeline_white_balance/src/.../convolutional_color_constancy.cpp),
after Barron, "Fast Fourier Color Constancy", CVPR 2017.

Per frame (reference balanceWhite, ccc.cpp:91-113):
  1. resize to 360x270 (INTER_LINEAR), convert to float32;
  2. log-chroma histogram (256x256) over non-saturated, finite pixels
     (ccc.cpp:210-271): u = round((log g - log r - uv0)/bin),
     v = round((log g - log b - uv0)/bin), clamped to [0,255], each
     contributing weight 1/(rows*cols) — normalized by *all* pixels, not
     just surviving ones (reference quirk, ccc.cpp:235-236);
  3. response = IDFT(DFT(hist) * DFT(filter) + DFT(bias)), row-major argmax
     (ccc.cpp:273-298). cv::dft's CCS packing + mulSpectrums is
     mathematically identical to the complex rfft2 product; the inverse's
     missing 1/N scale does not move the argmax;
  4. optional Kalman smoothing of the (x=col, y=row) peak (ccc.cpp:300-340);
  5. gains: Lu = x*bin + uv0, Lv = y*bin + uv0, gain_r = exp(Lu),
     gain_g = 1, gain_b = exp(Lv), normalized by the min gain; the
     z=sqrt(...) normalizer is computed then overwritten to 1.0 in the
     reference and therefore omitted here (ccc.cpp:362-367);
  6. apply per-channel gains with saturating round-half-even multiply.

Orientation subtlety replicated exactly: hist is indexed [u, v] (row = u =
green/red axis), the model filter/bias are transposed at load
(ccc.cpp:131-132 — handled in models/ccc_model.py), and the *column*
coordinate of the argmax drives gain_r while the *row* drives gain_b
(ccc.cpp:359-370).

The 65536-bin histogram is a one-hot contraction (an f32 einsum whose
integer counts are exact in any summation order) and the DFTs are real
256x256 matmul pairs; everything is batched over frames.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from raw_image_pipeline_tpu.models.ccc_model import CCCModel
from raw_image_pipeline_tpu.ops.common import round_u8
from raw_image_pipeline_tpu.ops.resize import resize_linear_u8

# Reference constants (ccc.cpp:19-33)
SMALL_W, SMALL_H = 360, 270
BIN_SIZE = 1.0 / 64.0
UV0 = -1.421875
HIST_N = 256


def _round_half_away(x):
    """C++ round(): half away from zero."""
    return jnp.where(x >= 0, jnp.floor(x + 0.5), jnp.ceil(x - 0.5))


# log() of every u8 value as cv::log computes it on the reference's float
# image (ccc.cpp:210-271): the correctly rounded f32 log, one ulp higher at
# five inputs (equal to cv2.log at all 256, tests/test_ccc.py);
# log(0) = -inf. Serving the histogram's logs from this table keeps its
# bins independent of the device's log implementation (XLA:CPU's own log
# differs from it at 5 of the 255 inputs; a pixel whose log-chroma sits on
# a bin edge moves with the last bit).
_LOG_U8 = np.array(
    [-np.inf] + [math.log(i) for i in range(1, 256)], np.float64
).astype(np.float32)
_CV_LOG_UP = [7, 49, 201, 217, 239]
_LOG_U8[_CV_LOG_UP] = np.nextafter(_LOG_U8[_CV_LOG_UP], np.float32(np.inf))

# The saturation mask thresholds the reference's gray value,
# cv::cvtColor(COLOR_BGR2GRAY) on CV_32F, which computes
# fma(r, cr, fma(b, cb, rn(g*cg))) (bit-exact over all 2^24 u8 triples,
# tests/test_ccc.py). Only `gray <= cut` is consumed, so it is decided
# without device float arithmetic (which a compiler may contract
# differently per backend):
#   T[b, g] = rn(b*cb + rn(g*cg))       65536-entry table, exact host math;
#   rn(r*cr + t) <= cut  <=>  t <= thr(cut)[r],
# because rounding is monotone in t; thr(cut)[r] is the largest table value
# that passes (gray_thresholds, per cut on the host).
_GRAY_CB, _GRAY_CG, _GRAY_CR = (
    np.float64(np.float32(c)) for c in (0.114, 0.587, 0.299)
)
_GRAY_BG = (
    np.arange(256, dtype=np.float64)[:, None] * _GRAY_CB
    + (np.arange(256, dtype=np.float64) * _GRAY_CG).astype(np.float32)[None, :]
).astype(np.float32).ravel()  # index b*256 + g; every sum is exact in f64
_GRAY_BG_SORTED = np.unique(_GRAY_BG)


def gray_thresholds(cut) -> np.ndarray:
    """[256] f32: for each red value r, the largest T[b, g] with
    rn32(r*cr + T) <= cut (f32 cut), or -inf when none passes. Then
    gray(b, g, r) <= cut  <=>  T[b, g] <= thresholds[r]."""
    cut32 = np.float32(cut)
    out = np.full(256, -np.inf, np.float32)
    t = _GRAY_BG_SORTED.astype(np.float64)
    for r in range(256):
        # r*cr + t is exact in f64; one rounding to f32 follows
        n_ok = int(np.count_nonzero((r * _GRAY_CR + t).astype(np.float32)
                                    <= cut32))
        if n_ok:
            out[r] = _GRAY_BG_SORTED[n_ok - 1]
    return out


def gray_mask_thresholds(bright_thr: float, dark_thr: float):
    """(gray_hi, gray_lo) [256] f32 threshold tables for the reference's
    `gray <= 255*bright_thr && gray > 255*dark_thr` (the f64 products
    narrowed to f32, as the reference's float comparison sees them)."""
    return (gray_thresholds(np.float32(255.0 * bright_thr)),
            gray_thresholds(np.float32(255.0 * dark_thr)))


@partial(jax.jit, static_argnames=("bright_thr", "dark_thr"))
def log_chroma_histogram(
    image: jax.Array, bright_thr: float = 0.9, dark_thr: float = 0.1,
    uv0: float = UV0,
) -> jax.Array:
    """[..., H, W, 3] uint8 BGR -> [..., 256, 256] float32 histogram.

    The image should already be the 360x270 working resize; H*W defines the
    reference's pixel_weight normalization. Thresholds/uv0 are trace-time
    floats here; the pipeline uses log_chroma_histogram_rt (runtime
    parameters — retuning never recompiles)."""
    gray_hi, gray_lo = gray_mask_thresholds(bright_thr, dark_thr)
    return _log_chroma_histogram_core(image, gray_hi, gray_lo, uv0)


@jax.jit
def log_chroma_histogram_rt(
    image: jax.Array, gray_hi: jax.Array, gray_lo: jax.Array,
    uv0: jax.Array,
) -> jax.Array:
    """Runtime-parameter variant: gray_hi/gray_lo are the [256] threshold
    tables of gray_mask_thresholds (host-computed from the bright/dark
    thresholds) and uv0 an f32 scalar. Retuning the CCC thresholds / uv0
    (the reference node's dynamic_reconfigure knobs,
    cfg/RawImagePipelineWhiteBalance.cfg:8-12) therefore never recompiles
    a built pipeline."""
    return _log_chroma_histogram_core(image, gray_hi, gray_lo, uv0)


def log_chroma_bins(image, gray_hi, gray_lo, uv0):
    """Per-pixel histogram coordinates of [..., H, W, 3] uint8 BGR pixels:
    (u, v) int32 bins and the bool `valid` mask (not saturated, not dark,
    finite logs). gray_hi/gray_lo: gray_mask_thresholds tables."""
    if image.dtype != jnp.uint8:
        raise TypeError(f"CCC histogram needs uint8 pixels, got {image.dtype}")
    px = image.astype(jnp.int32)
    b, g, r = px[..., 0], px[..., 1], px[..., 2]
    t = jnp.asarray(_GRAY_BG)[b * 256 + g]
    include = (t <= jnp.asarray(gray_hi)[r]) & (t > jnp.asarray(gray_lo)[r])

    logs = jnp.asarray(_LOG_U8)[px]
    log_b, log_g, log_r = logs[..., 0], logs[..., 1], logs[..., 2]
    finite = jnp.isfinite(log_r) & jnp.isfinite(log_g) & jnp.isfinite(log_b)
    valid = include & finite

    u = _round_half_away((log_g - log_r - uv0) / BIN_SIZE)
    v = _round_half_away((log_g - log_b - uv0) / BIN_SIZE)
    # non-finite logs produce nan bin coords; zero them before int cast
    # (they carry zero weight anyway)
    u = jnp.nan_to_num(u, nan=0.0, posinf=255.0, neginf=0.0)
    v = jnp.nan_to_num(v, nan=0.0, posinf=255.0, neginf=0.0)
    u = jnp.clip(u, 0, HIST_N - 1).astype(jnp.int32)
    v = jnp.clip(v, 0, HIST_N - 1).astype(jnp.int32)
    return u, v, valid


def _log_chroma_histogram_core(image, gray_hi, gray_lo, uv0):
    u, v, valid = log_chroma_bins(image, gray_hi, gray_lo, uv0)
    h, w = image.shape[-3], image.shape[-2]
    pixel_weight = jnp.float32(1.0 / (h * w))

    # Joint histogram as a contraction of one-hot factor matrices:
    #   count[a, b] = sum_p [u_p == a] * valid_p * [v_p == b]
    # Counts accumulate exactly (integers below 2^24 in f32, in any
    # summation order, and 0/1 factors are exact at any matmul precision);
    # the single final count*pixel_weight rounding is within ulps of the
    # reference's sequential `+= pixel_weight` loop (ccc.cpp:237-263),
    # which itself is order-dependent.
    lead = image.shape[:-3]
    u_flat = u.reshape((-1, h * w))
    v_flat = v.reshape((-1, h * w))
    valid_flat = valid.reshape((-1, h * w))
    iota = jnp.arange(HIST_N, dtype=jnp.int32)
    ou = (u_flat[..., None] == iota).astype(jnp.float32)
    ov = ((v_flat[..., None] == iota) & valid_flat[..., None]).astype(
        jnp.float32
    )
    counts = jnp.einsum(
        "bpu,bpv->buv", ou, ov, preferred_element_type=jnp.float32
    )
    # the barrier keeps XLA from folding pixel_weight into a dot operand,
    # where a TF32 GEMM would round it: on an H100 the histogram drifted
    # from the CPU's while every per-pixel bin agreed, and the barrier
    # brought it back to bit-equal
    counts = jax.lax.optimization_barrier(counts)
    hist = counts * pixel_weight
    return hist.reshape(lead + (HIST_N, HIST_N))


def _dft_matrices():
    """Real/imag parts of the 256-point DFT matrix (float32 constants)."""
    k = np.arange(HIST_N)
    ang = -2.0 * np.pi * np.outer(k, k) / HIST_N
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


_DFT_RE, _DFT_IM = _dft_matrices()


@partial(jax.jit, static_argnames=("precision",))
def ccc_response(hist: jax.Array, filt_dft_re: jax.Array, filt_dft_im: jax.Array,
                 bias_spatial: jax.Array, precision=None) -> jax.Array:
    """response = IDFT2(DFT2(hist) * DFT2(filt)).real + bias, [..., 256, 256].

    Mathematically identical to the reference's
    dft/mulSpectrums/add/idft chain (ccc.cpp:283-292) up to the inverse
    scale (which cv::dft omits and which cannot move the argmax): the bias
    term passes through DFT->IDFT untouched, so it is added in the spatial
    domain directly.

    Implemented as 10 real 256x256 matmuls: 2-D DFT2(X) = F X F^T done in
    real/imag parts, elementwise complex product with the precomputed
    filter DFT, then the real part of the inverse transform.
    """
    f32 = jnp.float32
    Fr = jnp.asarray(_DFT_RE)
    Fi = jnp.asarray(_DFT_IM)
    X = hist.astype(f32)

    # DEFAULT matmul precision (TF32 tensor cores on a GPU; the CPU
    # backend always computes true f32): the response only feeds an
    # argmax, and chip_smoke.py asserts on the device that the DEFAULT
    # argmax equals the HIGHEST-precision one on real-frame histograms.
    prec = jax.lax.Precision.DEFAULT if precision is None else precision

    def mm(a, b):
        return jnp.matmul(a, b, precision=prec, preferred_element_type=f32)

    # forward: Y = F X F^T  (X real)
    A = mm(X, Fr)          # X F^T == X Fr (F symmetric)
    B = mm(X, Fi)
    Yr = mm(Fr, A) - mm(Fi, B)
    Yi = mm(Fr, B) + mm(Fi, A)

    # elementwise complex product with the filter DFT
    Zr = Yr * filt_dft_re - Yi * filt_dft_im
    Zi = Yr * filt_dft_im + Yi * filt_dft_re

    # inverse: real(conj(F) Z conj(F)^T) / N^2
    # conj(F) = Fr - i Fi
    Ar = mm(Fr, Zr) + mm(Fi, Zi)
    Ai = mm(Fr, Zi) - mm(Fi, Zr)
    R = mm(Ar, Fr) + mm(Ai, Fi)
    resp = R * f32(1.0 / (HIST_N * HIST_N))
    return resp + bias_spatial.astype(f32)


@jax.jit
def response_argmax(response: jax.Array) -> jax.Array:
    """Row-major first-occurrence argmax -> [..., 2] int32 (x=col, y=row),
    matching cv::minMaxLoc's maxLoc Point convention (ccc.cpp:295)."""
    lead = response.shape[:-2]
    flat = response.reshape(lead + (-1,))
    idx = jnp.argmax(flat, axis=-1).astype(jnp.int32)
    row = idx // HIST_N
    col = idx % HIST_N
    return jnp.stack([col, row], axis=-1)


def gains_from_offsets(lu: float, lv: float, uv0: float = UV0) -> jax.Array:
    """Debug-UV-offset mode gains (setDebugUVOffset, ccc.cpp:349-357):
    Lu = lu - uv0, Lv = lv - uv0, then the same gain math as gains_from_uv."""
    Lu = lu - uv0
    Lv = lv - uv0

    gain_r = math.exp(Lu)  # libm exp = the reference's std::exp
    gain_b = math.exp(Lv)
    gains = np.array([gain_b, 1.0, gain_r], np.float32)
    return jnp.asarray(gains / gains.min())


def gains_from_uv(uv_pos: jax.Array, uv0: float = UV0) -> jax.Array:
    """uv_pos [..., 2] int (x, y) -> [..., 3] float32 BGR gains
    (ccc.cpp:342-381; z forced to 1, min-normalized)."""
    x = uv_pos[..., 0].astype(jnp.float32)
    y = uv_pos[..., 1].astype(jnp.float32)
    Lu = x * BIN_SIZE + uv0
    Lv = y * BIN_SIZE + uv0
    gain_r = jnp.exp(Lu)
    gain_b = jnp.exp(Lv)
    gain_g = jnp.ones_like(gain_r)
    gains = jnp.stack([gain_b, gain_g, gain_r], axis=-1)
    factor = jnp.min(gains, axis=-1, keepdims=True)
    return gains / factor


@jax.jit
def apply_gains(image: jax.Array, gains: jax.Array) -> jax.Array:
    """cv::multiply(image, Scalar(gain_b, gain_g, gain_r)) — saturating
    round-half-even (verified exact vs cv2)."""
    return round_u8(image.astype(jnp.float32) * gains[..., None, None, :])


def apply_gains_planes(planes, gains: jax.Array):
    """Planar form of apply_gains: tuple of [..., H, W] u8 planes (BGR
    order) -> tuple. Same arithmetic — bit-identical per channel."""
    return tuple(
        round_u8(p.astype(jnp.float32) * gains[..., c, None, None])
        for c, p in enumerate(planes)
    )


# ---------------------------------------------------------------------------
# Kalman temporal consistency (ccc.cpp:180-206, 300-340)
# ---------------------------------------------------------------------------
#
# cv::KalmanFilter(2, 2, 0) with F = I, Q = I, H = I, R = 10*I and
# errorCovPost initialized to 0. With everything isotropic the covariance
# stays p*I for a scalar p, so the exact recurrence is:
#     predict: p' = p + 1
#     gain:    k  = p' / (p' + 10)
#     update:  x  = x + k*(z - x);  p = (1 - k) * p'
# First measurement initializes x directly (statePost = z) and leaves p = 0.
# The reference then truncates the float estimate into the integer cv::Point
# (ccc.cpp:336-337) before computing gains — replicated via trunc().


@jax.tree_util.register_dataclass
@dataclass
class KalmanState:
    """Per-camera illuminant track. Fields broadcast over leading axes."""

    x: jax.Array  # [..., 2] float32 state (col, row)
    p: jax.Array  # [...] float32 isotropic covariance
    initialized: jax.Array  # [...] bool


def kalman_init(batch_shape=(), uv_init=(HIST_N // 2, HIST_N // 2)) -> KalmanState:
    """Fresh state (first_frame_=true). uv_init mirrors the reference's
    statePre/statePost prior of (height/2, width/2) (ccc.cpp:185-188)."""
    x = jnp.broadcast_to(jnp.asarray(uv_init, jnp.float32), batch_shape + (2,))
    return KalmanState(
        x=x,
        p=jnp.zeros(batch_shape, jnp.float32),
        initialized=jnp.zeros(batch_shape, bool),
    )


def kalman_scan(state: KalmanState, meas: jax.Array) -> Tuple[KalmanState, jax.Array]:
    """Advance one illuminant track through a time-ordered sequence of
    measurements in a single dispatch.

    meas: [T, ..., 2] int32 per-frame argmax peaks, time along axis 0;
    state fields broadcast over the trailing batch shape `...` (independent
    cameras). Returns (state after frame T-1, filtered uv [T, ..., 2]).

    This is the batched-streaming factorization of the reference's per-frame
    cv::KalmanFilter carry (ccc.cpp:300-340): the heavy CCC stages
    (resize/histogram/response/argmax) batch over T frames in one dispatch
    and only this 4-flop recurrence runs sequentially.
    """
    return jax.lax.scan(kalman_update, state, meas)


@jax.jit
def kalman_update(state: KalmanState, meas: jax.Array) -> Tuple[KalmanState, jax.Array]:
    """One filter step. meas: [..., 2] int32 measured peak (x, y).
    Returns (new_state, filtered uv [..., 2] int32)."""
    z = meas.astype(jnp.float32)
    p_pred = state.p + 1.0
    k = p_pred / (p_pred + 10.0)
    x_upd = state.x + k[..., None] * (z - state.x)
    p_upd = (1.0 - k) * p_pred

    init = state.initialized
    new_x = jnp.where(init[..., None], x_upd, z)
    new_p = jnp.where(init, p_upd, state.p)
    new_state = KalmanState(
        x=new_x, p=new_p, initialized=jnp.ones_like(init) | init
    )
    uv = jnp.trunc(new_x).astype(jnp.int32)
    return new_state, uv


# ---------------------------------------------------------------------------
# Full per-frame CCC
# ---------------------------------------------------------------------------


def ccc_balance_white(
    image: jax.Array,
    model: CCCModel,
    bright_thr: float = 0.9,
    dark_thr: float = 0.1,
    state: Optional[KalmanState] = None,
    uv0: float = UV0,
):
    """Full CCC white balance on [..., H, W, 3] uint8 BGR frames.

    Returns (balanced image, new_state). With state=None (temporal
    consistency off) the raw per-frame argmax drives the gains and
    new_state is None.
    """
    small = resize_linear_u8(image, SMALL_H, SMALL_W)
    hist = log_chroma_histogram(small, bright_thr, dark_thr, uv0)
    resp = ccc_response(
        hist,
        jnp.asarray(model.filt_dft_re),
        jnp.asarray(model.filt_dft_im),
        jnp.asarray(model.bias),
    )
    uv = response_argmax(resp)
    if state is not None:
        state, uv = kalman_update(state, uv)
    gains = gains_from_uv(uv, uv0)
    return apply_gains(image, gains), state
