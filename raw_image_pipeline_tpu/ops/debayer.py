"""Bayer demosaic.

Two algorithms, matching the reference's two backends:

  * ``bilinear`` — bit-exact replica of ``cv::demosaicing(..., COLOR_Bayer*2BGR)``,
    the reference CPU path (reference: modules/debayer.cpp:45-79). Interior
    pixels use 2/4-neighbor averages with OpenCV's rounding
    ((a+b+1)>>1, (sum+2)>>2); the first/last output row and column replicate
    the adjacent computed row/column (verified empirically against cv2).
  * ``mht`` — Malvar-He-Cutler 5x5 linear demosaic, the algorithm of the
    reference GPU path (``cv::cuda::demosaicing(..., *_MHT)``,
    modules/debayer.cpp:89-120). Bit-identical to the MHC'04 paper
    stencils evaluated in floats + round-half-even over a CLAMP-TO-EDGE
    mosaic (the CUDA kernel's ``cudaAddressModeClamp`` texture reads),
    asserted full-frame including the 2-px border ring against an
    INDEPENDENT pure-numpy float oracle written from the paper
    (tests/test_debayer.py::test_mht_matches_independent_paper_oracle).
    The OpenCV CUDA kernel itself is not used here; see
    debayer_mht's docstring for the border-convention derivation and the
    one residual caveat (outermost 1-px ring is unwritten/undefined in
    some opencv_contrib versions).

Phase convention: OpenCV's COLOR_BayerXX2BGR codes define the CFA phase from
pixel (1,1), so e.g. ``bayer_bggr8`` (ROS: top-left pixel Blue) maps to a
layout whose top-left sample is *Red* in OpenCV's interpretation. We key
everything on the empirically-verified per-code phase table below.

The reference CPU path additionally swaps R<->B after demosaicing
("Fix because apparently the CPU demosaicing produces RGB",
debayer.cpp:49-52); that swap is applied by the pipeline module (not here)
when replicating reference CPU output.

Everything is pure elementwise arithmetic on shifted views, which XLA
fuses into a single pass over device memory.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from raw_image_pipeline_tpu.ops.common import avg2, avg4, saturate_u8

# OpenCV code -> channel at (row%2, col%2) == (0,0),(0,1),(1,0),(1,1).
# Empirically verified against cv2.demosaicing (see tests/test_debayer.py).
_CV_PHASE = {
    "bg": "rggb",  # COLOR_BayerBG2BGR: (0,0)=R (0,1)=G (1,0)=G (1,1)=B
    "gb": "grbg",  # COLOR_BayerGB2BGR
    "rg": "bggr",  # COLOR_BayerRG2BGR
    "gr": "gbrg",  # COLOR_BayerGR2BGR
}

# ROS encoding -> OpenCV Bayer code used by the reference (debayer.cpp:45-79).
ENCODING_TO_CV_CODE = {
    "bayer_bggr8": "bg",
    "bayer_gbrg8": "gb",
    "bayer_grbg8": "gr",
    "bayer_rggb8": "rg",
}

BAYER_ENCODINGS = tuple(ENCODING_TO_CV_CODE)

# 16-bit patterns: listed by the reference but unimplemented there
# (debayer.hpp:74-81 — SURVEY.md §8.2). Supported here as an extension
# via debayer_bilinear16 when DebayerConfig.bayer16 != "error".
BAYER16_ENCODINGS = (
    "bayer_bggr16", "bayer_gbrg16", "bayer_grbg16", "bayer_rggb16",
)


def phase_for_encoding(encoding: str) -> str:
    """Physical CFA phase (channel of sample (0,0) etc.) for a ROS encoding,
    under OpenCV's interpretation of the matching COLOR_Bayer code."""
    return _CV_PHASE[ENCODING_TO_CV_CODE[encoding]]


def _site_masks(h: int, w: int, phase: str, row_off: int = 0, col_off: int = 0):
    """Boolean masks (h, w) for R / G-in-R-row / G-in-B-row / B sample sites.
    row_off/col_off shift the parity (for border strips computed on slabs
    whose first output pixel is not the frame's (0,0))."""
    row = (jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) + row_off) & 1
    col = (jax.lax.broadcasted_iota(jnp.int32, (h, w), 1) + col_off) & 1
    # even-even, even-odd, odd-even, odd-odd selectors
    ee = (row == 0) & (col == 0)
    eo = (row == 0) & (col == 1)
    oe = (row == 1) & (col == 0)
    oo = (row == 1) & (col == 1)
    cells = {"rggb": (ee, eo, oe, oo), "grbg": (eo, ee, oo, oe),
             "gbrg": (oe, oo, ee, eo), "bggr": (oo, oe, eo, ee)}
    r_site, g_r_row, g_b_row, b_site = cells[phase]
    return r_site, g_r_row, g_b_row, b_site


def _shifts(x):
    """Zero-padded 1-px and diagonal shifted views of [..., H, W].
    Pad in the INPUT dtype (u8/u16) and let callers widen the views — the
    padded copy is the one materialized buffer here, and padding after
    widening would double its traffic."""
    p = jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(1, 1), (1, 1)])
    n = p[..., :-2, 1:-1]
    s = p[..., 2:, 1:-1]
    w = p[..., 1:-1, :-2]
    e = p[..., 1:-1, 2:]
    nw = p[..., :-2, :-2]
    ne = p[..., :-2, 2:]
    sw = p[..., 2:, :-2]
    se = p[..., 2:, 2:]
    return n, s, w, e, nw, ne, sw, se


def _replicate_border(img):
    """Replace output border rows/cols with the adjacent computed ones,
    as cv::demosaicing does (verified empirically).

    Concat form: each .at[].set dynamic-update-slice re-materializes the
    whole [B,H,W,3] buffer; two concats of views copy the output once per
    axis instead."""
    img = jnp.concatenate(
        [img[..., 1:2, :, :], img[..., 1:-1, :, :], img[..., -2:-1, :, :]],
        axis=-3,
    )
    img = jnp.concatenate(
        [img[..., :, 1:2, :], img[..., :, 1:-1, :], img[..., :, -2:-1, :]],
        axis=-2,
    )
    return img


@partial(jax.jit, static_argnames=("phase",))
def debayer_bilinear(bayer: jax.Array, phase: str) -> jax.Array:
    """Bilinear demosaic, bit-exact vs cv::demosaicing.

    Args:
        bayer: [..., H, W] uint8 raw frame(s).
        phase: physical CFA phase of sample (0,0): one of
            'rggb' | 'grbg' | 'gbrg' | 'bggr' (OpenCV interpretation —
            use phase_for_encoding() to map a ROS encoding).
    Returns:
        [..., H, W, 3] uint8 BGR (same channel order cv2 produces).
    """
    h, w = bayer.shape[-2], bayer.shape[-1]
    i16 = lambda v: v.astype(jnp.int16)
    x = i16(bayer)
    n, s, wv, e, nw, ne, sw, se = _shifts(bayer)  # u8 views, widened per use

    v2 = avg2(i16(n), i16(s))
    h2 = avg2(i16(wv), i16(e))
    n4 = avg4(i16(n), i16(s), i16(wv), i16(e))
    d4 = avg4(i16(nw), i16(ne), i16(sw), i16(se))

    r_site, g_r_row, g_b_row, b_site = _site_masks(h, w, phase)
    g_site = g_r_row | g_b_row

    g = jnp.where(g_site, x, n4)
    r = jnp.where(r_site, x, jnp.where(g_r_row, h2, jnp.where(g_b_row, v2, d4)))
    b = jnp.where(b_site, x, jnp.where(g_b_row, h2, jnp.where(g_r_row, v2, d4)))

    out = saturate_u8(jnp.stack([b, g, r], axis=-1))
    # border replication runs on the u8 result, where its copies move a
    # quarter of the int16 bytes; replication commutes with the
    # elementwise saturate
    return _replicate_border(out)


def _mht_core(p, h, w, phase, row_off=0, col_off=0, sy=0, sx=0):
    """MHC'04 stencil over a pre-padded buffer p (any border semantics):
    output window is h x w starting at padded position (2+sy, 2+sx);
    row_off/col_off give the window's global parity for the site masks.

    Integer arithmetic: filters scaled by 16 (so the paper's 1/2 and 3/2
    coefficients are integers), descale by 4 bits with round-half-even —
    bit-identical to the float paper stencils + rint (asserted against an
    independent numpy oracle)."""

    def sh(dy, dx):
        return p[..., 2 + sy + dy: 2 + sy + dy + h,
                 2 + sx + dx: 2 + sx + dx + w].astype(jnp.int32)

    c = sh(0, 0)
    n1, s1, w1, e1 = sh(-1, 0), sh(1, 0), sh(0, -1), sh(0, 1)
    n2, s2, w2, e2 = sh(-2, 0), sh(2, 0), sh(0, -2), sh(0, 2)
    nw, ne_, sw, se_ = sh(-1, -1), sh(-1, 1), sh(1, -1), sh(1, 1)

    cross4 = n1 + s1 + w1 + e1          # 4 edge neighbors
    diag4 = nw + ne_ + sw + se_         # 4 corner neighbors
    axial4 = n2 + s2 + w2 + e2          # 4 two-step axial

    # G at R/B site:            (8c + 4*cross4 - 2*axial4) / 16
    g_at_rb = 8 * c + 4 * cross4 - 2 * axial4
    # R/B at G, estimate along the row (same-row chroma neighbors):
    #   (10c + 8*(w1+e1) - 2*diag4 - 2*(w2+e2) + (n2+s2)) / 16
    rb_at_g_h = 10 * c + 8 * (w1 + e1) - 2 * diag4 - 2 * (w2 + e2) + (n2 + s2)
    rb_at_g_v = 10 * c + 8 * (n1 + s1) - 2 * diag4 - 2 * (n2 + s2) + (w2 + e2)
    # R at B site / B at R site: (12c + 4*diag4 - 3*axial4) / 16
    rb_at_br = 12 * c + 4 * diag4 - 3 * axial4

    def desc8(v):
        # v/16 with round-half-even (= rint of the float stencil value)
        q = (v + 8) >> 4
        return q - (((v & 15) == 8) & ((q & 1) == 1)).astype(v.dtype)

    r_site, g_r_row, g_b_row, b_site = _site_masks(h, w, phase, row_off, col_off)
    g_site = g_r_row | g_b_row

    g = jnp.where(g_site, c, desc8(g_at_rb))
    r = jnp.where(
        r_site, c,
        jnp.where(g_r_row, desc8(rb_at_g_h),
                  jnp.where(g_b_row, desc8(rb_at_g_v), desc8(rb_at_br))),
    )
    b = jnp.where(
        b_site, c,
        jnp.where(g_b_row, desc8(rb_at_g_h),
                  jnp.where(g_r_row, desc8(rb_at_g_v), desc8(rb_at_br))),
    )
    return saturate_u8(jnp.stack([b, g, r], axis=-1))


def _edge_pad2(a):
    """Pad 2 px on every side by edge replication (concat form; only runs
    on the thin border slabs)."""
    a = jnp.concatenate(
        [a[..., :1, :], a[..., :1, :], a, a[..., -1:, :], a[..., -1:, :]],
        axis=-2,
    )
    a = jnp.concatenate(
        [a[..., :, :1], a[..., :, :1], a, a[..., :, -1:], a[..., :, -1:]],
        axis=-1,
    )
    return a


@partial(jax.jit, static_argnames=("phase",))
def debayer_mht(bayer: jax.Array, phase: str) -> jax.Array:
    """Malvar-He-Cutler 5x5 linear demosaic (reference GPU algorithm,
    ``cv::cuda::demosaicing(..., *_MHT)``, modules/debayer.cpp:89-120).

    Border: the CUDA kernel (opencv_contrib debayer.cu, McGuire's port of
    the MHC shader) reads the mosaic through a texture with
    ``cudaAddressModeClamp`` — out-of-bounds taps clamp to the edge sample
    of the raw mosaic (which flips their Bayer parity; that color bleed is
    the reference's own border behavior, reproduced here). The full 5x5
    stencil is therefore evaluated at every pixel over a clamp-to-edge
    mosaic: the interior (fast path) pads with zeros and the 2-px ring is
    overwritten from clamp-padded border slabs. Note some opencv_contrib
    versions skip writing the outermost 1-px ring entirely (leaving
    whatever was in the freshly-allocated GpuMat — undefined); the
    clamp-stencil value produced here is the deterministic value consistent
    with the kernel's own texture addressing.
    """
    h, w = bayer.shape[-2], bayer.shape[-1]
    if h < 4 or w < 4:  # degenerate frames: clamp-pad the whole mosaic
        return _mht_core(_edge_pad2(bayer), h, w, phase)

    p0 = jnp.pad(bayer, [(0, 0)] * (bayer.ndim - 2) + [(2, 2), (2, 2)])
    out = _mht_core(p0, h, w, phase)

    # clamp-exact 2-px border strips (slab cost is negligible; the corner
    # values agree between the row and column strips — both are the full
    # clamp stencil)
    top = _mht_core(_edge_pad2(bayer[..., 0:4, :]), 2, w, phase)
    bot = _mht_core(_edge_pad2(bayer[..., h - 4:h, :]), 2, w, phase,
                    row_off=h - 2, sy=2)
    left = _mht_core(_edge_pad2(bayer[..., :, 0:4]), h, 2, phase)
    right = _mht_core(_edge_pad2(bayer[..., :, w - 4:w]), h, 2, phase,
                      col_off=w - 2, sx=2)
    # concat instead of dynamic-update-slice (see _replicate_border); the
    # left/right strips' corner values equal the top/bottom ones, so the
    # column concat stays consistent after the row concat
    out = jnp.concatenate([top, out[..., 2:h - 2, :, :], bot], axis=-3)
    out = jnp.concatenate(
        [left, out[..., :, 2:w - 2, :], right], axis=-2
    )
    return out


@partial(jax.jit, static_argnames=("phase",))
def debayer_bilinear16(bayer: jax.Array, phase: str) -> jax.Array:
    """Bilinear demosaic for 16-bit raw frames (extension — the
    reference only lists these patterns and throws, debayer.hpp:74-81).
    Same interpolation/rounding as the 8-bit path, int32 internals.

    bayer: [..., H, W] uint16 -> [..., H, W, 3] uint16 BGR.
    """
    h, w = bayer.shape[-2], bayer.shape[-1]
    i32 = lambda v: v.astype(jnp.int32)
    x = i32(bayer)
    n, s, wv, e, nw, ne, sw, se = _shifts(bayer)  # u16 views, widened per use

    v2 = avg2(i32(n), i32(s))
    h2 = avg2(i32(wv), i32(e))
    n4 = avg4(i32(n), i32(s), i32(wv), i32(e))
    d4 = avg4(i32(nw), i32(ne), i32(sw), i32(se))

    r_site, g_r_row, g_b_row, b_site = _site_masks(h, w, phase)
    g_site = g_r_row | g_b_row

    g = jnp.where(g_site, x, n4)
    r = jnp.where(r_site, x, jnp.where(g_r_row, h2, jnp.where(g_b_row, v2, d4)))
    b = jnp.where(b_site, x, jnp.where(g_b_row, h2, jnp.where(g_r_row, v2, d4)))

    out = jnp.clip(jnp.stack([b, g, r], axis=-1), 0, 65535).astype(jnp.uint16)
    return _replicate_border(out)


def debayer(bayer: jax.Array, encoding: str, algorithm: str = "bilinear") -> jax.Array:
    """Demosaic by ROS encoding name, in cv2 channel conventions (BGR out,
    before the reference's CPU R<->B swap quirk)."""
    if encoding in BAYER16_ENCODINGS:
        phase = _CV_PHASE[{"bayer_bggr16": "bg", "bayer_gbrg16": "gb",
                           "bayer_grbg16": "gr", "bayer_rggb16": "rg"}[encoding]]
        return debayer_bilinear16(bayer, phase)
    phase = phase_for_encoding(encoding)
    if algorithm == "bilinear":
        return debayer_bilinear(bayer, phase)
    if algorithm == "mht":
        return debayer_mht(bayer, phase)
    raise ValueError(f"Unknown demosaic algorithm: {algorithm}")


def debayer_planes(bayer: jax.Array, encoding: str, algorithm: str = "bilinear"):
    """Demosaic straight to three channel planes (c0, c1, c2), identical
    to debayer(...)[..., 0/1/2]. The planes are slices of the packed
    stencil output, which XLA fuses into the consumers of each plane."""
    img = debayer(bayer, encoding, algorithm)
    return img[..., 0], img[..., 1], img[..., 2]
