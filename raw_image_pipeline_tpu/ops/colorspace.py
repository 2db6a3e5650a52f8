"""Color-space conversions replicating OpenCV's u8 fixed-point arithmetic.

Needed for exact parity of two reference stages:
  * color enhancer: BGR -> HSV -> gain multiply -> BGR
    (reference: modules/color_enhancer.cpp:38-47)
  * vignetting: BGR -> Lab, scale L, Lab -> BGR
    (reference: modules/vignetting_correction.cpp:68-93)
plus BGR -> gray (float) for the CCC histogram mask
    (reference: convolutional_color_constancy.cpp:213).

Parity status (empirically measured against cv2 5.0; the assertions live in
tests/test_pointwise_ops.py and tests/test_planar.py, plus the on-chip
exhaustive device-vs-CPU sweeps in chip_smoke.py):
  * bgr_to_hsv_u8:   bit-exact (integer table arithmetic, hsv_shift=12).
  * hsv_to_bgr_u8:   bit-exact, verified against ALL 256^3 u8 HSV inputs
    (f32 chain with emulated-fma single rounding + final truncation,
    replicating cv2 5.0's SIMD).
  * bgr_to_lab_u8: bit-exact, verified against ALL 256^3 u8 BGR inputs
    (classic integer-table path; the cbrt table is built with an exact
    replica of OpenCV's softfloat f32 arithmetic, see _build_lab_tables).
  * lab_to_bgr_u8: bit-exact replica of cv2 5.0's Lab2RGBinteger fixed
    point path, verified against ALL 256^3 u8 Lab inputs.
  * bgr_to_gray_f32: float32 Y = 0.299R + 0.587G + 0.114B (within
    1e-3 of cv2; the CCC mask uses its own exact tables, ops/ccc.py).

All tables are built once in numpy at import time and closed over as
constants; XLA turns the gathers + elementwise math into fused kernels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from raw_image_pipeline_tpu.ops.common import descale, fma_f32
from raw_image_pipeline_tpu.ops.lut import CorrectedTable, fit_branch_poly, poly_eval

# ---------------------------------------------------------------------------
# HSV (hsv_shift = 12, matching OpenCV's RGB2HSV_b)
# ---------------------------------------------------------------------------

_HSV_SHIFT = 12


def _build_hsv_tables():
    sdiv = np.zeros(256, np.int32)
    hdiv = np.zeros(256, np.int32)
    v = np.arange(1, 256)
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / v).astype(np.int32)
    hdiv[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * v)).astype(np.int32)
    return sdiv, hdiv


_SDIV_TAB, _HDIV_TAB = _build_hsv_tables()

# Formula-served exact tables (see ops/lut.py): the arithmetic runs per
# pixel; entries where device float rounding differs from the exact table
# are patched by equality-selects.
_SDIV = CorrectedTable(
    lambda v: jnp.where(
        v == 0,
        0,
        jnp.rint((255 << _HSV_SHIFT) / jnp.maximum(v, 1).astype(jnp.float32)).astype(jnp.int32),
    ),
    _SDIV_TAB,
)
_HDIV = CorrectedTable(
    lambda d: jnp.where(
        d == 0,
        0,
        jnp.rint((180 << _HSV_SHIFT) / (6.0 * jnp.maximum(d, 1).astype(jnp.float32))).astype(jnp.int32),
    ),
    _HDIV_TAB,
)


def bgr_to_hsv_planes(b: jax.Array, g: jax.Array, r: jax.Array):
    """Planar core of bgr_to_hsv_u8: three same-shape u8 planes in, three
    u8 planes (h, s, v) out. Identical arithmetic to the packed form — the
    packed wrapper just slices/stacks around this — so every exactness
    claim below covers both. Planar callers skip the channel-minor u8
    slice/stack passes."""
    b = b.astype(jnp.int32)
    g = g.astype(jnp.int32)
    r = r.astype(jnp.int32)
    v = jnp.maximum(jnp.maximum(b, g), r)
    mn = jnp.minimum(jnp.minimum(b, g), r)
    diff = v - mn

    s = (diff * _SDIV(v) + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT

    h_num = jnp.where(
        v == r, g - b, jnp.where(v == g, b - r + 2 * diff, r - g + 4 * diff)
    )
    h = (h_num * _HDIV(diff) + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = h + jnp.where(h < 0, 180, 0)
    return h.astype(jnp.uint8), s.astype(jnp.uint8), v.astype(jnp.uint8)


@jax.jit
def bgr_to_hsv_u8(image: jax.Array) -> jax.Array:
    """Bit-exact replica of cv::cvtColor(COLOR_BGR2HSV) for uint8."""
    h, s, v = bgr_to_hsv_planes(image[..., 0], image[..., 1], image[..., 2])
    return jnp.stack([h, s, v], axis=-1)


# which of tab[0..3] feeds b,g,r per sector (OpenCV sector_data, RGB order
# reversed to BGR). Applied as elementwise selects, not gathers.
_SECTOR_DATA = (
    (1, 3, 0), (1, 0, 2), (3, 0, 1), (0, 2, 1), (0, 1, 3), (2, 1, 0)
)


def _dekker_fma_1_minus(s: jax.Array, ff: jax.Array) -> jax.Array:
    """rnd32(1 - s*ff) with a SINGLE rounding — the shared emulated fused
    multiply-add (ops/common.fma_f32, Dekker 2Product + TwoSum).

    cv2 5.0's SIMD HSV2BGR computes the v-table entries with real fmas;
    replicating the single-rounding semantics is what makes the conversion
    below bit-exact (verified exhaustively over all 2^24 inputs)."""
    return fma_f32(-s, ff, jnp.float32(1.0))


def _hsv_to_bgr_planes_core(h: jax.Array, s: jax.Array, v: jax.Array,
                            scalar_kernel: bool):
    """Shared HSV->BGR float chain. cv2 5.0's two row kernels differ ONLY
    in the final *255 conversion: the SIMD kernel (32-px vector steps)
    TRUNCATES, the scalar kernel (the `width % 32` tail of every row, or
    whole rows below 32 px) rounds via saturate_cast/cvRound (half-even).
    The tab entries are identical — the scalar source's plain
    `v*(1 - s*h)` is compiler-contracted into the same single-rounding
    fma the SIMD kernel uses (GCC -ffp-contract default; verified
    exhaustively: 0 mismatches vs cv2 on ALL 2^24 inputs for BOTH
    kernels, width-16 Mats isolating the scalar one)."""
    f32 = jnp.float32
    h = h.astype(f32)
    s = s.astype(f32) * f32(1.0 / 255.0)
    v = v.astype(f32) * f32(1.0 / 255.0)

    hf = h * f32(6.0 / 180.0)
    sector = jnp.floor(hf).astype(jnp.int32)
    ff = hf - sector.astype(f32)
    sector = sector % 6

    one = f32(1.0)
    tab = (
        v,
        v * (one - s),
        v * _dekker_fma_1_minus(s, ff),
        v * _dekker_fma_1_minus(s, one - ff),  # (1-ff) exact by Sterbenz
    )

    def pick(channel: int):
        out = tab[_SECTOR_DATA[0][channel]]
        for sec in range(1, 6):
            out = jnp.where(sector == sec, tab[_SECTOR_DATA[sec][channel]], out)
        prod = out * f32(255.0)
        if scalar_kernel:
            return jnp.clip(jnp.rint(prod), 0, 255).astype(jnp.uint8)
        return jnp.floor(prod).astype(jnp.uint8)

    return pick(0), pick(1), pick(2)


def hsv_to_bgr_planes(h: jax.Array, s: jax.Array, v: jax.Array):
    """Planar core of hsv_to_bgr_u8 (same arithmetic; see
    bgr_to_hsv_planes for the planar rationale).

    cv2 5.0's SIMD row kernel: h*(6/180) in f32, tables
    [v, v*(1-s), v*fma(-s,ff,1), v*fma(s,ff-1,1)], final *255 product
    TRUNCATED (no rounding). Verified equal on ALL 256^3 u8 HSV inputs
    (tests/test_pointwise_ops.py). For the scalar-kernel columns cv2 uses
    below its 32-px vector width see hsv_to_bgr_planes_scalar."""
    return _hsv_to_bgr_planes_core(h, s, v, scalar_kernel=False)


def hsv_to_bgr_planes_scalar(h: jax.Array, s: jax.Array, v: jax.Array):
    """cv2 5.0's SCALAR row kernel (saturate_cast rounding instead of the
    SIMD truncation; same fma tab entries — see _hsv_to_bgr_planes_core).
    cv2 applies it to the last `width % 32` pixels of every row (all
    pixels when width < 32); verified equal on ALL 256^3 u8 HSV inputs
    against width-16 cv2 Mats (tests/test_pointwise_ops.py)."""
    return _hsv_to_bgr_planes_core(h, s, v, scalar_kernel=True)


@jax.jit
def hsv_to_bgr_u8(image: jax.Array) -> jax.Array:
    """Bit-exact replica of cv::cvtColor(COLOR_HSV2BGR) for uint8."""
    b, g, r = hsv_to_bgr_planes(image[..., 0], image[..., 1], image[..., 2])
    return jnp.stack([b, g, r], axis=-1)


# ---------------------------------------------------------------------------
# Lab (integer-table path; lab_shift=12, gamma_shift=3)
# ---------------------------------------------------------------------------

_LAB_SHIFT = 12
_GAMMA_SHIFT = 3
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT
_CBRT_TAB_SIZE = 3072
_WHITEPT = (0.950456, 1.0, 1.088754)
_XYZ_COEF = (
    0.412453, 0.357580, 0.180423,
    0.212671, 0.715160, 0.072169,
    0.019334, 0.119193, 0.950227,
)


def _softfloat_cbrt_f32(xbits: np.ndarray) -> np.ndarray:
    """Bit-exact replica of OpenCV's cv::cbrt(softfloat) (host, init time).

    Reverse-engineered from libopencv_core 4.6 (f32_cbrt): cv::cubeRoot's
    quartic rational polynomial evaluated in IEEE f64 on the fraction
    (f32 bits split so fr in [0.125, 1)), then the f64 quotient is
    converted to f32 by mantissa TRUNCATION (bits >> 29) with the result
    exponent rebuilt as (ex - shx)/3 — not a rounded conversion. Verified
    equal on 200k random f32 bit patterns plus the whole LabCbrtTab_b
    domain. In/out are f32 bit patterns (uint32)."""
    xbits = np.asarray(xbits, np.uint32)
    ix = (xbits & 0x7FFFFFFF).astype(np.int64)
    sign = xbits & 0x80000000
    ex = (ix >> 23) - 127
    shx = np.fmod(ex, 3)  # C trunc semantics
    shx = shx - np.where(shx >= 0, 3, 0)
    ex_out = (ex - shx) // 3  # exact: (ex - shx) divisible by 3
    frbits = ((ix & ((1 << 23) - 1)) | ((shx + 127) << 23)).astype(np.uint32)
    fr = frbits.view(np.float32).astype(np.float64)
    num = (((45.2548339756803022511987494 * fr + 192.2798368355061050458134625) * fr
            + 119.1654824285581628956914143) * fr + 13.43250139086239872172837314) * fr \
        + 0.1636161226585754240958355063
    den = (((14.80884093219134573786480845 * fr + 151.9714051044435648658557668) * fr
            + 168.5254414101568283957668343) * fr + 33.9905941350215598754191872) * fr + 1.0
    q = num / den  # in [0.5, 1): cbrt of fr
    man = (q.view(np.uint64) >> np.uint64(29)) & np.uint64(0x7FFFFF)
    out = (sign.astype(np.uint64)
           | ((126 + ex_out).astype(np.uint64) << np.uint64(23)) | man)
    return np.where(ix == 0, xbits, out.astype(np.uint32))


def _build_lab_tables():
    # rounded (not truncated) gamma-table construction matches cv2 5.0's
    # 8u path exactly (verified against the table dumped from a live
    # libopencv_imgproc 4.6, itself exhaustively equal to cv2 5.0)
    i = np.arange(256, dtype=np.float64) / 255.0
    lin = np.where(i <= 0.04045, i / 12.92, ((i + 0.055) / 1.055) ** 2.4)
    gamma_tab = np.rint(255.0 * (1 << _GAMMA_SHIFT) * lin).astype(np.int32)

    # cbrt table: OpenCV builds this with softfloat (f32) arithmetic —
    # x = i * (1/2040) in f32, cbrt via the truncating polynomial above,
    # scaled by 2^15 in f32, cvRound = half-to-even. Two entries (49, 628)
    # land exactly on .5 in f32 and differ from a float64 build; matching
    # the construction op-for-op makes the whole BGR->Lab conversion
    # bit-exact vs cv2 on all 2^24 inputs (tests/test_pointwise_ops.py).
    f32 = np.float32
    scale = f32(1.0) / (f32(255) * f32(1 << _GAMMA_SHIFT))
    x = (scale * np.arange(_CBRT_TAB_SIZE, dtype=f32)).astype(f32)
    lthresh = (f32(216) / f32(24389)).astype(f32)
    lscale = (f32(841) / f32(108)).astype(f32)
    lbias = (f32(16) / f32(116)).astype(f32)
    # mulAdd(x, lscale, lbias): fused (single-rounding) via exact f64
    lin_branch = (x.astype(np.float64) * np.float64(lscale)
                  + np.float64(lbias)).astype(f32)
    cbrt_branch = _softfloat_cbrt_f32(x.view(np.uint32)).view(f32)
    fx = np.where(x < lthresh, lin_branch, cbrt_branch)
    scaled = (f32(1 << _LAB_SHIFT2) * fx).astype(f32)
    cbrt_tab = np.rint(scaled.astype(np.float64)).astype(np.int32)  # half-even

    coef = np.array(
        [
            np.rint(_XYZ_COEF[j] * (1 << _LAB_SHIFT) / _WHITEPT[j // 3])
            for j in range(9)
        ],
        np.int32,
    )
    return gamma_tab, cbrt_tab, coef


_GAMMA_TAB, _CBRT_TAB, _LAB_COEF = _build_lab_tables()


# The pow/cbrt branches of the table formulas are served by low-degree
# polynomials in sqrt-index space (2 ops per degree vs tens for each
# transcendental); fit on host at import against the unrounded f64 curve,
# with per-platform corrections (CorrectedTable) still guaranteeing the
# bit-exact table values. See ops/lut.fit_branch_poly.
_lab_gamma_i = np.arange(256, dtype=np.float64)
_sel = _lab_gamma_i / 255.0 > 0.04045
_LAB_GAMMA_POLY = fit_branch_poly(
    256, _lab_gamma_i[_sel],
    2040.0 * ((_lab_gamma_i[_sel] / 255.0 + 0.055) / 1.055) ** 2.4,
)

del _lab_gamma_i, _sel


def _lab_gamma_formula(i):
    f32 = jnp.float32
    x = i.astype(f32) * f32(1.0 / 255.0)
    if _LAB_GAMMA_POLY is not None:
        hi = poly_eval(i, *_LAB_GAMMA_POLY, 256)
    else:  # fit failed on this host's BLAS — fall back to the transcendental
        hi = f32(2040.0) * jnp.power((x + f32(0.055)) * f32(1.0 / 1.055), f32(2.4))
    scaled = jnp.where(x <= 0.04045, f32(2040.0 / 12.92) * x, hi)
    return jnp.rint(scaled).astype(jnp.int32)


def _cbrt_formula(i):
    # a degree-17 sqrt-domain poly fits this table too; the native cbrt
    # was the faster of the two on the first target (not measured on the
    # H100) — the transcendental stays
    f32 = jnp.float32
    x = i.astype(f32) * f32(1.0 / (255 * (1 << _GAMMA_SHIFT)))
    f = jnp.where(
        x < 0.008856,
        x * f32(7.787) + f32(0.13793103448275862),
        jnp.cbrt(x),
    )
    return jnp.rint(f * f32(1 << _LAB_SHIFT2)).astype(jnp.int32)


_LAB_GAMMA = CorrectedTable(_lab_gamma_formula, _GAMMA_TAB)
_LAB_CBRT = CorrectedTable(_cbrt_formula, _CBRT_TAB)


def bgr_to_lab_planes(b: jax.Array, g: jax.Array, r: jax.Array,
                      gamma_fn=None):
    """Planar core of bgr_to_lab_u8 (same arithmetic; see
    bgr_to_hsv_planes for the planar rationale).

    gamma_fn: optional replacement for the 256-entry sRGB-linearize table
    (u8 int32 in -> int32 table values). The pipeline composes the ISP
    gamma stage's u8->u8 map into this table when gamma feeds straight
    into vignetting (ops/vignetting.composed_gamma_lab_fn) — one fused
    table lookup instead of two stages."""
    C = [int(c) for c in _LAB_COEF]
    gf = gamma_fn if gamma_fn is not None else _LAB_GAMMA

    b = gf(b.astype(jnp.int32))
    g = gf(g.astype(jnp.int32))
    r = gf(r.astype(jnp.int32))

    def cbrt_tab(v):
        return _LAB_CBRT(jnp.clip(v, 0, _CBRT_TAB_SIZE - 1))

    fX = cbrt_tab(descale(r * C[0] + g * C[1] + b * C[2], _LAB_SHIFT))
    fY = cbrt_tab(descale(r * C[3] + g * C[4] + b * C[5], _LAB_SHIFT))
    fZ = cbrt_tab(descale(r * C[6] + g * C[7] + b * C[8], _LAB_SHIFT))

    l_scale = (116 * 255 + 50) // 100
    l_shift = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)
    L = descale(l_scale * fY + l_shift, _LAB_SHIFT2)
    a = descale(500 * (fX - fY) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    bb = descale(200 * (fY - fZ) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    clip = lambda v: jnp.clip(v, 0, 255).astype(jnp.uint8)
    return clip(L), clip(a), clip(bb)


@jax.jit
def bgr_to_lab_u8(image: jax.Array) -> jax.Array:
    """Bit-exact replica of cv::cvtColor(COLOR_BGR2Lab) for uint8
    (sRGB gamma, D65; verified against all 2^24 inputs).

    Both integer tables (256-entry sRGB linearize, 3072-entry cbrt) are
    served by their float formulas with device-derived sparse corrections
    (ops/lut.py), exactly matching cv2's softfloat-built host tables.
    """
    L, a, bb = bgr_to_lab_planes(image[..., 0], image[..., 1], image[..., 2])
    return jnp.stack([L, a, bb], axis=-1)


# --- exact integer Lab->BGR (cv2 5.0 Lab2RGBinteger path) ------------------
#
# Reverse-engineered empirically and verified bit-exact against
# cv2.cvtColor(COLOR_Lab2BGR) on ALL 256^3 u8 Lab triples (see
# tests/test_pointwise_ops.py). Structure (fixed point, BASE = 2^14):
#   y, ify         : per-L tables (CIE L -> Y and f(Y), both BASE-scaled);
#   adiv, bdiv     : integer approximations of (a-128)*BASE/500 and
#                    (b-128)*BASE/200 (the +1 on bdiv is in the original);
#   x, z           : f-value -> chromaticity via a piecewise table whose
#                    entries have the closed forms  i*108/841 - 290  (linear
#                    branch, C-truncated division) and  ((i*i)/B)*i/B
#                    (cubic branch) — evaluated directly, no gather;
#   s              : per-channel 3x3 XYZ->sRGB row sum, coeffs
#                    round(4096 * M * whitept) (columns premultiplied by the
#                    D65 white point);
#   out            : i = (s + 8192) >> 14, clipped to [0, 8191], then the
#                    inverse-sRGB-gamma table round(255 * gamma(i/4096)).
# The vignetting module composes this after scaling L
# (reference: modules/vignetting_correction.cpp:68-93).

_LAB2_BASE = 1 << 14
_LAB2_MIN_AB = -8145
_LAB2_AB_MAX = _LAB2_BASE * 9 // 4 + _LAB2_MIN_AB - 1


def _lab2_yf_tables():
    f = np.float32
    i = np.arange(256)
    li = (i * 100 / f(255)).astype(f)
    lthresh = f(0.008856) * f(903.3)
    ylo = np.rint((_LAB2_BASE * (li / f(903.3))).astype(f))
    ifylo = np.rint(
        (_LAB2_BASE * (f(7.787) * (li / f(903.3)) + f(16.0 / 116.0))).astype(f)
    )
    fy = ((li + 16) / f(116)).astype(f)
    ifyhi = np.rint((_LAB2_BASE * fy).astype(f))
    yhi = np.rint((_LAB2_BASE * fy * fy * fy).astype(f))
    lo = li <= lthresh
    y = np.where(lo, ylo, yhi).astype(np.int32)
    ify = np.where(lo, ifylo, ifyhi).astype(np.int32)
    return y, ify


_LAB2_Y_TAB, _LAB2_IFY_TAB = _lab2_yf_tables()


def _lab2_y_formula(i):
    f32 = jnp.float32
    li = i.astype(f32) * f32(100.0 / 255.0)
    lo = jnp.rint(f32(_LAB2_BASE) * (li / f32(903.3)))
    fy = (li + f32(16.0)) / f32(116.0)
    hi = jnp.rint(f32(_LAB2_BASE) * fy * fy * fy)
    return jnp.where(li <= f32(0.008856) * f32(903.3), lo, hi).astype(jnp.int32)


def _lab2_ify_formula(i):
    f32 = jnp.float32
    li = i.astype(f32) * f32(100.0 / 255.0)
    lo = jnp.rint(
        f32(_LAB2_BASE) * (f32(7.787) * (li / f32(903.3)) + f32(16.0 / 116.0))
    )
    hi = jnp.rint(f32(_LAB2_BASE) * (li + f32(16.0)) / f32(116.0))
    return jnp.where(li <= f32(0.008856) * f32(903.3), lo, hi).astype(jnp.int32)


_LAB2_Y = CorrectedTable(_lab2_y_formula, _LAB2_Y_TAB)
_LAB2_IFY = CorrectedTable(_lab2_ify_formula, _LAB2_IFY_TAB)


def _lab2_inv_gamma_table():
    f = np.float32
    i = np.arange(8192)
    x = (i / f(4096)).astype(f)
    g = np.where(
        x <= f(0.0031308),
        x * f(12.92),
        f(1.055) * np.power(x, f(1 / 2.4), dtype=f) - f(0.055),
    )
    return np.clip(np.rint((f(255) * g).astype(f)), 0, 255).astype(np.int32)


_lab2_ig_i = np.arange(8192, dtype=np.float64)
_lab2_ig_x = _lab2_ig_i / 4096.0
_lab2_ig_sel = _lab2_ig_x > 0.0031308
_LAB2_INV_GAMMA_POLY = fit_branch_poly(
    8192, _lab2_ig_i[_lab2_ig_sel],
    255.0 * (1.055 * _lab2_ig_x[_lab2_ig_sel] ** (1.0 / 2.4) - 0.055),
    degrees=range(6, 26),
)
del _lab2_ig_i, _lab2_ig_x, _lab2_ig_sel


def _lab2_inv_gamma_formula(i):
    # pow branch poly-served in sqrt-index space (deg 10, a few live
    # corrections per platform)
    f32 = jnp.float32
    x = i.astype(f32) * f32(1.0 / 4096.0)
    if _LAB2_INV_GAMMA_POLY is not None:
        hi = poly_eval(i, *_LAB2_INV_GAMMA_POLY, 8192)
    else:  # host fit failed — fall back to the transcendental
        hi = f32(255.0) * (
            f32(1.055)
            * jnp.power(jnp.maximum(x, f32(1e-9)), f32(1.0 / 2.4))
            - f32(0.055)
        )
    g = jnp.where(x <= f32(0.0031308), x * f32(12.92 * 255.0), hi)
    return jnp.clip(jnp.rint(g), 0, 255).astype(jnp.int32)


_LAB2_INV_GAMMA = CorrectedTable(
    _lab2_inv_gamma_formula, _lab2_inv_gamma_table(), max_corr=64
)


def _lab2_coeffs():
    M = (
        (3.240479, -1.53715, -0.498535),
        (-0.969256, 1.875991, 0.041556),
        (0.055648, -0.204043, 1.057311),
    )
    return [
        [int(np.rint(np.float64(4096 * M[r][c] * _WHITEPT[c]))) for c in range(3)]
        for r in range(3)
    ]


_LAB2_COEF = _lab2_coeffs()


def _trunc_div(a: jax.Array, b: int) -> jax.Array:
    """C/C++ integer division (truncation toward zero) for int32 arrays.

    Computes a float32 quotient estimate (error < 1 for the magnitudes used here) and repair
    it exactly with one integer residue check in each direction.
    """
    f32 = jnp.float32
    q = jnp.trunc(a.astype(f32) * f32(1.0 / b)).astype(jnp.int32)
    r = a - q * b
    pos = a >= 0
    q = q + jnp.where(pos & (r >= b), 1, 0) - jnp.where(pos & (r < 0), 1, 0)
    q = q - jnp.where(~pos & (r <= -b), 1, 0) + jnp.where(~pos & (r > 0), 1, 0)
    return q


def _lab2_ab_to_xz(i: jax.Array) -> jax.Array:
    """abToXZ_b table entries computed in closed form from the index."""
    i = jnp.clip(i, _LAB2_MIN_AB, _LAB2_AB_MAX)
    lin = _trunc_div(i * 108, 841) - 290  # 290 == ((BASE*16/116)*108)/841
    # the cubic branch is only selected for i > 3390, where i, i*i and
    # q*i are all non-negative (i <= AB_MAX = 28718 keeps q*i < 2^31), so
    # the truncating /BASE divisions are exact arithmetic shifts, cheaper
    # than the float-estimate _trunc_div repair chains. Negative i
    # evaluate the shifts too (floor != trunc there) but are discarded by
    # the select.
    q = (i * i) >> 14
    cub = (q * i) >> 14
    return jnp.where(i <= 3390, lin, cub)


def lab_to_bgr_planes(L: jax.Array, a: jax.Array, b: jax.Array):
    """Planar core of lab_to_bgr_u8 (same arithmetic; see
    bgr_to_hsv_planes for the planar rationale)."""
    i32 = jnp.int32
    L = L.astype(i32)
    a = a.astype(i32)
    b = b.astype(i32)

    y = _LAB2_Y(L)
    ify = _LAB2_IFY(L)

    adiv = ((5 * a * 53687 + (1 << 7)) >> 13) - 128 * _LAB2_BASE // 500
    bdiv = ((b * 41943 + (1 << 4)) >> 9) - 128 * _LAB2_BASE // 200 + 1
    x = _lab2_ab_to_xz(ify + adiv)
    z = _lab2_ab_to_xz(ify - bdiv)

    C = _LAB2_COEF

    def channel(row):
        s = C[row][0] * x + C[row][1] * y + C[row][2] * z
        idx = jnp.clip((s + 8192) >> 14, 0, 8191)
        return _LAB2_INV_GAMMA(idx).astype(jnp.uint8)

    return channel(2), channel(1), channel(0)


@jax.jit
def lab_to_bgr_u8(image: jax.Array) -> jax.Array:
    """Bit-exact replica of cv::cvtColor(COLOR_Lab2BGR) for uint8
    (verified against all 2^24 inputs; see module docstring above)."""
    b, g, r = lab_to_bgr_planes(image[..., 0], image[..., 1], image[..., 2])
    return jnp.stack([b, g, r], axis=-1)


# ---------------------------------------------------------------------------
# Gray
# ---------------------------------------------------------------------------


@jax.jit
def bgr_to_gray_f32(image: jax.Array) -> jax.Array:
    """cv::cvtColor(COLOR_BGR2GRAY) on CV_32F: Y = 0.299R + 0.587G + 0.114B."""
    f32 = jnp.float32
    x = image.astype(f32)
    return x[..., 2] * f32(0.299) + x[..., 1] * f32(0.587) + x[..., 0] * f32(0.114)
