"""cv2-compatible INTER_LINEAR resize for uint8 images — bit-exact at ANY
scale ratio.

Replicates OpenCV's 8u fixed-point bilinear resize (imgproc resize.cpp)
semantics exactly:

  * source coordinate ``fx = (float)((dx+0.5)*scale_x - 0.5)`` — the
    product/subtract run in double and are then narrowed to FLOAT;
    ``sx = cvFloor(fx); fx -= sx`` in float;
  * border overrides: ``sx < 0 -> sx=0, fx=0``;
    ``sx >= src-1 -> sx=src-1, fx=0`` (second tap weight 0);
  * the two 11-bit coefficients are quantized INDEPENDENTLY —
    ``a0 = cvRound((1.f-fx)*2048.f)``, ``a1 = cvRound(fx*2048.f)`` (both
    float multiplies, half-even rounding); their sum is 2047/2048/2049,
    not always 2048;
  * horizontal pass accumulates ``S[sx]*a0 + S[sx+1]*a1`` in int32 with NO
    descale; the 8u vertical pass is OpenCV's specialized truncating form
    ``uchar((((b0*(S0>>4)) >> 16) + ((b1*(S1>>4)) >> 16) + 2) >> 2)``
    (VResizeLinear<uchar,...> specialization; its SIMD mul-hi path computes
    the same values).

Because of the truncating shifts the passes do NOT commute, so the
horizontal pass runs first like OpenCV's. Parity: bit-exact vs cv2 for
integer AND non-integer ratios (tests/test_resize_exact.py sweeps odd
sizes both ways).

Index/weight tables are built on host at trace time (static shapes), so the
device code is two gathers + integer multiply-adds that XLA fuses.

Reference use: the CCC working resize (convolutional_color_constancy.cpp:95)
feeds the histogram from a 360x270 INTER_LINEAR downsample of any camera
size.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _coords(src: int, dst: int):
    """fx/sx per OpenCV resize.cpp: scale = 1/(dst/src) in double,
    fx = (float)((dx+0.5)*scale - 0.5), sx = cvFloor(fx), fx -= sx."""
    scale = 1.0 / (dst / src)                          # 1./inv_scale, double
    x = np.arange(dst, dtype=np.float64)
    fxf = ((x + 0.5) * scale - 0.5).astype(np.float32)  # (float) cast
    sx = np.floor(fxf).astype(np.int64)                # cvFloor of the float
    f = (fxf - sx.astype(np.float32)).astype(np.float32)  # fx -= sx (float)
    return sx, f


def _quant(f):
    """saturate_cast<short>((1.f-fx)*2048.f), saturate_cast<short>(fx*2048.f):
    both products in f32, cvRound = half-even; quantized INDEPENDENTLY (the
    pair sums to 2047/2048/2049, not always 2048)."""
    a1 = np.rint(f * np.float32(2048.0)).astype(np.int32)
    a0 = np.rint((np.float32(1.0) - f) * np.float32(2048.0)).astype(np.int32)
    return a0, a1


def _tables_x(src: int, dst: int):
    """Horizontal tables: OpenCV overrides the border coefficients
    (sx < 0 -> sx=0, fx=0; sx >= src-1 -> sx=src-1, fx=0)."""
    sx, f = _coords(src, dst)
    left = sx < 0
    f = np.where(left, np.float32(0.0), f)
    sx = np.where(left, 0, sx)
    right = sx >= src - 1
    f = np.where(right, np.float32(0.0), f)
    sx = np.where(right, src - 1, sx)
    a0, a1 = _quant(f)
    sx2 = np.minimum(sx + 1, src - 1)  # weight-0 tap at the right border
    return sx.astype(np.int32), sx2.astype(np.int32), a0, a1


def _tables_y(src: int, dst: int):
    """Vertical tables: NO coefficient override — resizeGeneric_ clamps the
    row POINTERS (srows[k] = ptr(clip(sy+k))) but keeps the raw quantized
    (1-fy, fy) weights, so an upsample's first/last rows blend the edge row
    with itself using fy's unclamped fractional part (fy can come from a
    negative coordinate). Reproducing that asymmetry is what makes upsample
    border rows bit-exact."""
    sy, f = _coords(src, dst)
    b0, b1 = _quant(f)
    sy0 = np.clip(sy, 0, src - 1)
    sy1 = np.clip(sy + 1, 0, src - 1)
    return sy0.astype(np.int32), sy1.astype(np.int32), b0, b1


def _periodic_structure(src: int, dst: int, s0: np.ndarray, s1: np.ndarray):
    """Detect the reduced-fraction tap pattern s0[q*t + j] == p*t + c_j (with
    s1 == s0 + 1 and both taps inside group t) that every rational downscale
    src/dst = p/q exhibits away from clamped borders. Verified directly
    against the exact tables, so borders/odd ratios that break it simply
    fall back to the gather path. Returns (p, q, c[j]) or None."""
    import math

    g = math.gcd(src, dst)
    p, q = src // g, dst // g
    if q > 8 or dst % q or p < 2:
        return None
    t = np.arange(dst) // q
    j = np.arange(dst) % q
    c = s0[:q].astype(np.int64)
    if (c < 0).any() or (c + 1 > p - 1).any():
        return None
    if not np.array_equal(s0, p * t + c[j]) or not np.array_equal(s1, s0 + 1):
        return None
    return p, q, c


@partial(jax.jit, static_argnames=("dst_h", "dst_w"))
def resize_linear_u8(image: jax.Array, dst_h: int, dst_w: int) -> jax.Array:
    """image: [..., H, W, C] uint8 -> [..., dst_h, dst_w, C] uint8.

    Implementation: when the tap tables follow the periodic reduced-fraction pattern (any
    rational downscale away from clamped borders — both Alphasense feeds),
    the four jnp.take gathers are replaced by reshape + static slices with
    per-class weight vectors: identical taps, identical weights, identical
    integer arithmetic — bit-exact by construction — with zero gather
    traffic. Non-periodic shapes (upsamples, clamped borders) keep the
    take-based formulation, horizontal pass first. OpenCV's pass order is
    also the exactness requirement: the truncating vertical shifts do not
    commute."""
    src_h, src_w = image.shape[-3], image.shape[-2]
    sx, sx2, a0, a1 = _tables_x(src_w, dst_w)
    sy, sy2, b0, b1 = _tables_y(src_h, dst_h)

    xs = _periodic_structure(src_w, dst_w, sx, sx2)
    ys = _periodic_structure(src_h, dst_h, sy, sy2)
    lead = image.shape[:-3]
    if xs is not None and ys is not None:
        px_, qx, cx = xs
        py_, qy, cy = ys
        tx, ty = dst_w // qx, dst_h // qy
        i32 = jnp.int32
        xg = image.reshape(lead + (src_h, tx, px_, -1))
        # horizontal: per column class j, taps are STATIC indices into the
        # stride-px_ groups; weights become [tx]-vectors (no constancy
        # assumption — the exact per-column quantized values apply as-is)
        hs = []
        for j in range(qx):
            w0 = jnp.asarray(a0.reshape(tx, qx)[:, j])[:, None]
            w1 = jnp.asarray(a1.reshape(tx, qx)[:, j])[:, None]
            hs.append(
                xg[..., int(cx[j]), :].astype(i32) * w0
                + xg[..., int(cx[j]) + 1, :].astype(i32) * w1
            )
        hbuf = jnp.stack(hs, axis=-2)  # [..., H, tx, qx, C]
        hbuf = hbuf.reshape(lead + (src_h, dst_w, -1))
        # vertical: same structure on rows, OpenCV's truncating 8u form
        vg = hbuf.reshape(lead + (ty, py_, dst_w, hbuf.shape[-1]))
        vs = []
        for j in range(qy):
            w0 = jnp.asarray(b0.reshape(ty, qy)[:, j])[:, None, None]
            w1 = jnp.asarray(b1.reshape(ty, qy)[:, j])[:, None, None]
            s0 = vg[..., int(cy[j]), :, :] >> 4
            s1 = vg[..., int(cy[j]) + 1, :, :] >> 4
            vs.append((((w0 * s0) >> 16) + ((w1 * s1) >> 16) + 2) >> 2)
        acc = jnp.stack(vs, axis=-3)  # [..., ty, qy, dst_w, C]
        acc = acc.reshape(lead + (dst_h, dst_w, acc.shape[-1]))
        return jnp.clip(acc, 0, 255).astype(jnp.uint8)

    # horizontal pass over the full height (u8 takes widen after fetch)
    hbuf = (
        jnp.take(image, jnp.asarray(sx), axis=-2).astype(jnp.int32)
        * jnp.asarray(a0)[:, None]
        + jnp.take(image, jnp.asarray(sx2), axis=-2).astype(jnp.int32)
        * jnp.asarray(a1)[:, None]
    )
    # vertical: OpenCV's 8u specialization (truncating shifts; all values
    # non-negative so >> is floor division, matching C++)
    s0 = jnp.take(hbuf, jnp.asarray(sy), axis=-3) >> 4
    s1 = jnp.take(hbuf, jnp.asarray(sy2), axis=-3) >> 4
    acc = (
        ((jnp.asarray(b0)[:, None, None] * s0) >> 16)
        + ((jnp.asarray(b1)[:, None, None] * s1) >> 16)
        + 2
    ) >> 2
    # the arithmetic cannot exceed 255 (see VResizeLinear's raw uchar cast);
    # clip is a semantic no-op kept as a guard
    return jnp.clip(acc, 0, 255).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("dst_h", "dst_w"))
def resize_linear_u8_plane(img: jax.Array, dst_h: int, dst_w: int) -> jax.Array:
    """Single-plane resize: [..., H, W] u8 (W in lanes) -> [..., dst_h,
    dst_w] u8. Identical arithmetic to resize_linear_u8(img[..., None])
    [..., 0] — bit-exact by the shared tables (asserted in
    tests/test_resize_exact.py) — restructured for planar input:

      * no channel-minor axis of size 1;
      * vertical tap rows are selected BEFORE the horizontal pass via the
        reverse reshape (in-group static slices, no strided access), so
        the horizontal pass runs only on the rows the vertical combine
        consumes;
      * per-class outputs concatenate and the final small u8 output
        un-permutes columns in one transpose.

    Not measured on the H100 against the packed form. Non-periodic shapes
    fall back to the packed implementation."""
    src_h, src_w = img.shape[-2], img.shape[-1]
    sx, sx2, a0, a1 = _tables_x(src_w, dst_w)
    sy, sy2, b0, b1 = _tables_y(src_h, dst_h)
    xs = _periodic_structure(src_w, dst_w, sx, sx2)
    ys = _periodic_structure(src_h, dst_h, sy, sy2)
    if xs is None or ys is None:
        return resize_linear_u8(img[..., None], dst_h, dst_w)[..., 0]
    px_, qx, cx = xs
    py_, qy, cy = ys
    tx, ty = dst_w // qx, dst_h // qy
    lead = img.shape[:-2]
    i32 = jnp.int32
    vgr = img.reshape(lead + (ty, py_, src_w))

    def horiz(x):  # [..., ty, W] -> [..., ty, qx*tx] class-blocked int32
        xg = x.reshape(lead + (ty, tx, px_))
        hs = []
        for j in range(qx):
            w0 = jnp.asarray(a0.reshape(tx, qx)[:, j])
            w1 = jnp.asarray(a1.reshape(tx, qx)[:, j])
            hs.append(xg[..., int(cx[j])].astype(i32) * w0
                      + xg[..., int(cx[j]) + 1].astype(i32) * w1)
        return jnp.concatenate(hs, axis=-1)

    vs = []
    for j in range(qy):
        s0 = horiz(vgr[..., int(cy[j]), :]) >> 4
        s1 = horiz(vgr[..., int(cy[j]) + 1, :]) >> 4
        wb0 = jnp.asarray(b0.reshape(ty, qy)[:, j])[:, None]
        wb1 = jnp.asarray(b1.reshape(ty, qy)[:, j])[:, None]
        vs.append((((wb0 * s0) >> 16) + ((wb1 * s1) >> 16) + 2) >> 2)
    if qy == 1:
        acc = vs[0]
    else:
        # dst row = qy*t + j: stack classes minor against the t axis
        acc = jnp.stack(vs, axis=-2).reshape(lead + (dst_h, qx * tx))
    out = jnp.clip(acc, 0, 255).astype(jnp.uint8)
    out = out.reshape(lead + (dst_h, qx, tx))
    perm = tuple(range(out.ndim - 2)) + (out.ndim - 1, out.ndim - 2)
    # dst col = qx*t + j: un-block the class-major columns
    return jnp.transpose(out, perm).reshape(lead + (dst_h, dst_w))
