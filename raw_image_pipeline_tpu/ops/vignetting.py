"""Polynomial vignetting correction (reference: modules/vignetting_correction.cpp).

Mask: k(r) = a2*r^2 + a4*r^4 with r the distance from the image center,
normalized by its max, scaled, plus one (vignetting_correction.cpp:32-63).
Apply: BGR -> Lab, L(float32) * mask, saturate back to u8, Lab -> BGR
(vignetting_correction.cpp:68-93).

The reference recomputes the mask every frame for non-square images due to
a swapped cache-guard (line 33, SURVEY.md §8.5) — output-invariant, so we
fix it: the mask is precomputed once on host (float64, like the reference's
double loop) and closed over as a constant.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from raw_image_pipeline_tpu.ops.colorspace import (
    bgr_to_lab_planes,
    bgr_to_lab_u8,
    lab_to_bgr_planes,
    lab_to_bgr_u8,
)
from raw_image_pipeline_tpu.ops.common import round_u8


def build_vignetting_mask(height: int, width: int, scale: float, a2: float, a4: float) -> np.ndarray:
    """[H, W] float32 multiplier mask (host-side, init time)."""
    cy = height / 2.0
    cx = width / 2.0
    y = np.arange(height, dtype=np.float64)[:, None]
    x = np.arange(width, dtype=np.float64)[None, :]
    r2 = (y - cy) ** 2 + (x - cx) ** 2
    k = r2 * a2 + r2 * r2 * a4
    mx = k.max()
    if mx > 0:
        k = k / mx
    k = k * scale + 1.0
    return k.astype(np.float32)


def correct_planes(b: jax.Array, g: jax.Array, r: jax.Array, mask: jax.Array,
                   gamma_fn=None):
    """Planar form: three u8 planes + broadcast-compatible f32 mask ->
    three u8 planes. Same arithmetic as `correct` (bit-identical; the
    packed op slices/stacks around the same planar cores).

    gamma_fn: optional composed first-stage table (see
    composed_gamma_lab_fn below) replacing the Lab forward's sRGB
    linearization — used by the pipeline to fold the ISP gamma stage in."""
    L, a, bb = bgr_to_lab_planes(b, g, r, gamma_fn=gamma_fn)
    # materialize the forward half's u8 planes: the whole roundtrip fused
    # into one kernel spilled on the first target, and two u8 [H,W,B]
    # passes were cheaper (not re-measured on the H100). Identity op,
    # bit-exactness unaffected.
    L, a, bb = jax.lax.optimization_barrier((L, a, bb))
    L = round_u8(L.astype(jnp.float32) * mask.astype(jnp.float32))
    return lab_to_bgr_planes(L, a, bb)


@jax.jit
def correct(image: jax.Array, mask: jax.Array) -> jax.Array:
    """image: [..., H, W, 3] uint8 BGR; mask: [H, W] float32."""
    lab = bgr_to_lab_u8(image)
    L = lab[..., 0].astype(jnp.float32) * mask.astype(jnp.float32)
    lab = lab.at[..., 0].set(round_u8(L))
    return lab_to_bgr_u8(lab)


# ---------------------------------------------------------------------------
# Gamma-stage composition (round-5 steady-state lever): in the reference
# chain the gamma LUT's output is consumed ONLY by vignetting when both
# stages are enabled (gamma_correction.cpp:54-60 feeding
# vignetting_correction.cpp:68-93), so the two 256-entry maps compose into
# ONE: ctab[i] = LAB_GAMMA_TAB[gamma_lut_k[i]]. The composed table is
# served the usual way (gamma poly -> u8 -> lab-gamma poly, with ONE
# sparse correction set pinning the exact composed entries) — this deletes
# the gamma stage's own correction-select chain and rint/clip per plane.
# Exactness is
# provable by 256-entry enumeration (tests/test_pointwise_ops.py) and the
# fast-path==reference-order pipeline pin.
# ---------------------------------------------------------------------------


def composed_gamma_lab_table(k: float) -> np.ndarray:
    """Exact int32 [256] table: reference gamma LUT then OpenCV's Lab sRGB
    linearize table (the composition the device formula must reproduce)."""
    from raw_image_pipeline_tpu.ops.colorspace import _GAMMA_TAB
    from raw_image_pipeline_tpu.ops.gamma import build_gamma_lut

    return _GAMMA_TAB[build_gamma_lut(k).astype(np.int64)].astype(np.int32)


def _composed_formula(x, coeffs, root: int):
    """Device formula for the composed table: the gamma stage's poly-served
    u8 map chained into the Lab forward's linearize formula (both WITHOUT
    their own corrections — one composed correction set covers the pair)."""
    from raw_image_pipeline_tpu.ops.colorspace import _lab_gamma_formula
    from raw_image_pipeline_tpu.ops.gamma import _gamma_poly_formula

    g = _gamma_poly_formula(x, coeffs, root)
    return _lab_gamma_formula(g.astype(jnp.int32))


def composed_gamma_corrections(k: float, coeffs: np.ndarray, root: int,
                               max_corr: int):
    """(corr_idx, corr_val) pinning the composed formula to the exact
    composed table, derived on the current backend; raises if the mismatch
    count exceeds max_corr (callers then fall back to two stages)."""
    from raw_image_pipeline_tpu.ops.lut import derive_corrections

    cj = jnp.asarray(coeffs)
    return derive_corrections(
        lambda x: _composed_formula(x, cj, root),
        composed_gamma_lab_table(k), max_corr=max_corr,
    )


def composed_gamma_lab_fn(coeffs: jax.Array, corr_idx: jax.Array,
                          corr_val: jax.Array, root: int):
    """gamma_fn for bgr_to_lab_planes/correct_planes: exact composed
    lookup from runtime parameters (no recompile when k changes)."""
    from raw_image_pipeline_tpu.ops.lut import apply_corrected

    def fn(x):
        return apply_corrected(
            x, lambda v: _composed_formula(v, coeffs, root),
            corr_idx, corr_val,
        )

    return fn
