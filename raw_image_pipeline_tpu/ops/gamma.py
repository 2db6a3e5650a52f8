"""Gamma correction via 256-entry LUT (reference: modules/gamma_correction.cpp:35-60).

The reference builds lut[i] = saturate_cast<uchar>(pow(i/255, k) * 255) and
applies it with cv::LUT; both the "custom" and the CPU "default" method are
this same LUT (gamma_correction.cpp:58-60).

Here the lookup is served by evaluating the curve per pixel plus sparse
corrections for the handful of entries where device float rounding
differs from the exact host-built table (see ops/lut.py). The corrections
are derived at pipeline-build time on the platform the pipeline is built
for and passed as runtime parameters, so changing k never recompiles.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from raw_image_pipeline_tpu.ops.lut import (
    apply_corrected,
    derive_corrections,
    fit_branch_poly,
    poly_eval,
)


def build_gamma_lut(k: float) -> np.ndarray:
    """256-entry uint8 LUT, replicating the reference's float arithmetic:
    f = (float)(i/255.0); f = pow(f, k); lut[i] = cvRound(f * 255.0)."""
    i = np.arange(256, dtype=np.float64) / 255.0
    # libm pow (= the reference's std::pow), not np.power: numpy's SIMD
    # f64 pow can differ in the last ulp (no u8-visible case found over a
    # 441-value k sweep, but 256 scalar calls make the class impossible)
    f = np.array([math.pow(v, k) for v in i], np.float64).astype(np.float32)
    vals = np.rint(f.astype(np.float64) * 255.0)
    return np.clip(vals, 0, 255).astype(np.uint8)


def _gamma_formula(x, k):
    f32 = jnp.float32
    xf = x.astype(f32) * f32(1.0 / 255.0)
    p = jnp.power(xf, jnp.asarray(k, f32))
    return jnp.clip(jnp.rint(p * f32(255.0)), 0, 255).astype(jnp.uint8)


def gamma_corrections(k: float):
    """(corr_idx, corr_val) patching the device pow formula to the exact
    reference LUT, derived on the current backend."""
    return derive_corrections(
        lambda x: _gamma_formula(x, k), build_gamma_lut(k),
        max_corr=GAMMA_MAX_CORR,
    )


def gamma_apply(image: jax.Array, k: jax.Array, corr_idx: jax.Array, corr_val: jax.Array) -> jax.Array:
    """Exact LUT application: formula + corrections (all runtime args)."""
    x = image.astype(jnp.int32)
    return apply_corrected(x, lambda v: _gamma_formula(v, k), corr_idx, corr_val)


def gamma_correct(image: jax.Array, k: float) -> jax.Array:
    """Convenience one-shot (derives corrections on current backend)."""
    idx, val = gamma_corrections(k)
    return gamma_apply(image, jnp.float32(k), jnp.asarray(idx), jnp.asarray(val))


# --- polynomial-served LUT (the pipeline's fast path) -----------------------
# pow costs tens of ops per pixel; for every practical k the 256-entry curve
# fits a degree<=9 polynomial in sqrt(i/255) space whose f32 Horner is ~20
# ops, with residual rounding differences patched by the same correction
# machinery. Coefficients are runtime parameters (front-padded to a fixed
# length), so changing k still never recompiles.

GAMMA_POLY_LEN = 10  # highest-degree-first, zeros-padded at the front

# Runtime-parameter correction pad: the deg<=9 fits below stay within 8
# mismatches by construction (fit_branch_poly's budget), plus whatever the
# platform's rounding adds; each pad entry costs a compare+select per pixel
# in the hot path. A platform needing more than the pad fails loudly at
# build time (derive_corrections raises).
GAMMA_MAX_CORR = 16


import functools


@functools.lru_cache(maxsize=64)
def gamma_poly_coeffs(k: float):
    """([GAMMA_POLY_LEN] f32 Horner coefficients, root) for 255*(i/255)^k
    in t = 2*(i/255)^(1/root)-1 space, or None if no degree<=9 fit is close
    enough in either domain (then the pow formula path is used instead).
    The sqrt domain covers k >= ~0.5; the cbrt domain covers small k.

    Memoized: make_params and make_isp_fn both consult this for the same k
    (one builds the corrections, the other the static trace plan), and the
    cache guarantees they see the SAME fit rather than agreeing by
    construction. Callers must not mutate the returned array."""
    i = np.arange(256, dtype=np.float64)
    target = 255.0 * np.power(i / 255.0, float(k))
    for root in (2, 3):
        fit = fit_branch_poly(
            256, i, target,
            budget=8, degrees=range(4, GAMMA_POLY_LEN), root=root,
        )
        if fit is not None:
            co, _lo, _hi = fit
            return np.concatenate(
                [np.zeros(GAMMA_POLY_LEN - len(co), np.float32), co]
            ).astype(np.float32), root
    return None


def _gamma_poly_formula(x, coeffs, root):
    y = poly_eval(x, coeffs, 0.0, 1.0, 256, root=root)
    return jnp.clip(jnp.rint(y), 0, 255).astype(jnp.uint8)


def gamma_corrections_poly(k: float, coeffs: np.ndarray, root: int):
    """(corr_idx, corr_val) patching the device poly formula to the exact
    reference LUT, derived on the current backend."""
    cj = jnp.asarray(coeffs)
    return derive_corrections(
        lambda x: _gamma_poly_formula(x, cj, root), build_gamma_lut(k),
        max_corr=GAMMA_MAX_CORR,
    )


def gamma_apply_poly(image: jax.Array, coeffs: jax.Array,
                     corr_idx: jax.Array, corr_val: jax.Array,
                     root: int = 2) -> jax.Array:
    """Exact LUT application via the poly formula + corrections."""
    x = image.astype(jnp.int32)
    return apply_corrected(
        x, lambda v: _gamma_poly_formula(v, coeffs, root), corr_idx, corr_val
    )


# ---------------------------------------------------------------------------
# GPU-backend "default" gamma: the reference's cv::cuda::gammaCorrection is
# NPP's nppiGammaFwd/Inv_8u_C3IR — a FIXED ITU-R BT.709 transfer curve that
# ignores k entirely; only the direction comes from k via
# is_forward = (k <= 1.0) (gamma_correction.cpp:29-33, 66-74).
# Forward (linear -> gamma):  X < 0.018 ? 4.5*X : 1.099*X^0.45 - 0.099
# Inverse (gamma -> linear):  Y < 0.081 ? Y/4.5 : ((Y+0.099)/1.099)^(1/0.45)
# No CUDA oracle exists on this host; the curve follows the published NPP
# GammaFwd/GammaInv specification with round-to-nearest u8 quantization.
# ---------------------------------------------------------------------------


def build_bt709_lut(forward: bool) -> np.ndarray:
    x = np.arange(256, dtype=np.float64) / 255.0
    if forward:
        y = np.where(x < 0.018, 4.5 * x, np.array([1.099 * math.pow(v, 0.45) for v in x]) - 0.099)
    else:
        y = np.where(x < 0.081, x / 4.5, np.array([math.pow((v + 0.099) / 1.099, 1.0 / 0.45) for v in x]))
    return np.clip(np.rint(y * 255.0), 0, 255).astype(np.uint8)


# pow branches served by import-time polynomial fits (see gamma_poly_coeffs
# above for the rationale; corrections still pin the exact table values)
_bt_i = np.arange(256, dtype=np.float64)
_bt_sel_f = _bt_i / 255.0 >= 0.018
_BT709_FWD_POLY = fit_branch_poly(
    256, _bt_i[_bt_sel_f],
    255.0 * (1.099 * np.array([math.pow(v, 0.45) for v in _bt_i[_bt_sel_f] / 255.0]) - 0.099),
)
_bt_sel_i = _bt_i / 255.0 >= 0.081
_BT709_INV_POLY = fit_branch_poly(
    256, _bt_i[_bt_sel_i],
    255.0 * np.array([math.pow(v, 1.0 / 0.45) for v in (_bt_i[_bt_sel_i] / 255.0 + 0.099) / 1.099]),
)
del _bt_i, _bt_sel_f, _bt_sel_i


def _bt709_formula(x, forward: bool):
    f32 = jnp.float32
    xf = x.astype(f32) * f32(1.0 / 255.0)
    if forward:
        if _BT709_FWD_POLY is not None:
            hi = poly_eval(x, *_BT709_FWD_POLY, 256)
        else:  # fit failed on this host's BLAS — transcendental fallback
            hi = f32(255.0) * (
                f32(1.099) * jnp.power(jnp.maximum(xf, f32(1e-9)), f32(0.45))
                - f32(0.099)
            )
        y = jnp.where(xf < f32(0.018), xf * f32(4.5 * 255.0), hi)
    else:
        if _BT709_INV_POLY is not None:
            hi = poly_eval(x, *_BT709_INV_POLY, 256)
        else:
            hi = f32(255.0) * jnp.power(
                (xf + f32(0.099)) * f32(1.0 / 1.099), f32(1.0 / 0.45)
            )
        y = jnp.where(xf < f32(0.081), xf * f32(255.0 / 4.5), hi)
    return jnp.clip(jnp.rint(y), 0, 255).astype(jnp.uint8)


def bt709_corrections(forward: bool):
    """(corr_idx, corr_val) patching the device formula to the exact
    host-built BT.709 LUT, derived on the current backend."""
    return derive_corrections(
        lambda x: _bt709_formula(x, forward), build_bt709_lut(forward),
        max_corr=GAMMA_MAX_CORR,
    )


def gamma_apply_bt709(image: jax.Array, forward: bool,
                      corr_idx: jax.Array, corr_val: jax.Array) -> jax.Array:
    """The GPU-backend 'default' gamma (fixed BT.709 curve, k ignored)."""
    x = image.astype(jnp.int32)
    return apply_corrected(
        x, lambda v: _bt709_formula(v, forward), corr_idx, corr_val
    )


# Back-compat alias used by tests: exact LUT application for an arbitrary
# 256-entry table via select tree (slow to compile; prefer gamma_apply).
def apply_lut(image: jax.Array, lut: jax.Array) -> jax.Array:
    from raw_image_pipeline_tpu.ops.common import lut_select

    return lut_select(image.astype(jnp.int32), lut).astype(lut.dtype)
