"""Statistical white-balance methods: simple, grey_world, pca, learned.

The reference dispatches on a method string (modules/white_balance.hpp:46-86):
  * "simple"      -> cv::xphoto::SimpleWB with clipping percentile p
  * "grey_world"  -> cv::xphoto::GrayworldWB with saturation threshold
  * "learned"     -> cv::xphoto::LearningBasedWB
  * "pca"         -> custom 2x2 solve (white_balance.cpp:73-136)
  * "ccc"         -> FFCC library (see ops/ccc.py)

All methods are per-frame global reductions followed by a per-pixel affine —
the reductions are jnp sums/maxes over the spatial axes (batched over
frames; under spatial sharding they become psum-style collectives inserted
by GSPMD), and the pixel math fuses with neighboring stages.

PCA replicates the reference arithmetic exactly. simple/grey_world were
reverse-engineered against the native libopencv_xphoto 4.6 oracle on this
machine (native/oracle/xphoto_oracle.cpp; tests/fixtures/wb_oracle/ holds
golden outputs):
  * grey_world: bit-exact — integer saturation mask
    (mx-mn)*255 <= cvRound(thr*255)*mx, integer channel sums, gains
    cvRound(256 * f32(smin)/f32(s)) applied as (v*gain) >> 8.
  * simple: bit-exact — histogram-walk quantiles (strict < against the
    f32 target p*total/100 from each end) and the convertTo stretch with
    double-computed, f32-cast (alpha, beta) coefficients applied as a
    single-rounded fma + half-even round (semantics read from the
    library's disassembly; tests/test_wb_oracle.py).
"learned" (LearningBasedWB) uses the REAL default model — trees extracted
from the library binary, features and consensus reverse-engineered; see
ops/learned_wb.py (bit-exact on the reference fixtures).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from raw_image_pipeline_tpu.ops.common import fma_f32, round_u8, seal_f32


def _channel_hists(image: jax.Array) -> jax.Array:
    """[..., H, W, 3] uint8 -> [..., 3, 256] int32 histograms via scatter-add."""

    def hist1(flat):  # [N] int32 -> [256]
        return jnp.zeros((256,), jnp.int32).at[flat].add(1)

    lead = image.shape[:-3]
    n = image.shape[-3] * image.shape[-2]
    flat = image.astype(jnp.int32).reshape((-1, n, 3)).transpose(0, 2, 1)  # [B', 3, N]
    h = jax.vmap(jax.vmap(hist1))(flat)  # [B', 3, 256]
    return h.reshape(lead + (3, 256))


# SimpleWB stretch coefficients: the library computes
#   alpha = (outputMax-outputMin)/(maxValue-minValue)   in DOUBLE,
#   beta  = outputMin - minValue*alpha                  in DOUBLE,
# hands them to cv::Mat::convertTo, which casts both to f32 and applies
# out = cvRound(fma(v, alpha32, beta32)) per pixel (disassembly of
# balanceWhiteSimple<uchar> in libopencv_xphoto 4.6). alpha/beta depend
# only on the per-frame scalars (p1, span), so exact f32 values for every
# combination are precomputed on the host; the device does 3 scalar
# lookups per frame.
_SIMPLE_SPAN = np.arange(257, dtype=np.float64)
_SIMPLE_SPAN[0] = 1.0
_SIMPLE_ALPHA64 = 255.0 / _SIMPLE_SPAN  # [257]
_SIMPLE_ALPHA32 = _SIMPLE_ALPHA64.astype(np.float32)
_SIMPLE_BETA32 = (
    -np.arange(256, dtype=np.float64)[:, None] * _SIMPLE_ALPHA64[None, :]
).astype(np.float32)  # [p1, span] -> f32(-p1 * alpha64)


@partial(jax.jit, static_argnames=("p",))
def balance_white_simple(image: jax.Array, p: float) -> jax.Array:
    """cv::xphoto::SimpleWB (setP(p)), 8u, default input/output ranges.

    Per channel (semantics from the libopencv_xphoto 4.6 oracle + its
    disassembly; bit-exact incl. the exact-.5 stretch positions):
      * 256-bin histogram; walk from each end while the cumulative count
        is strictly below the f32 target p*total/100 — stop bins p1/p2;
      * stretch out = cvRound(fma(v, alpha, beta)) with the
        double-computed, f32-cast convertTo coefficients above.
    """
    f32 = jnp.float32
    n = image.shape[-3] * image.shape[-2]
    hist = _channel_hists(image)  # [..., 3, 256] int32
    target = (f32(p) * f32(n)) / f32(100.0)

    cum = jnp.cumsum(hist, axis=-1).astype(f32)
    p1 = jnp.sum((cum < target).astype(jnp.int32), axis=-1)  # [..., 3]
    cum_top = jnp.cumsum(jnp.flip(hist, axis=-1), axis=-1).astype(f32)
    p2 = 255 - jnp.sum((cum_top < target).astype(jnp.int32), axis=-1)

    # degenerate p (>= ~50%): the f32 target can exceed the pixel count and
    # both walks run off the histogram (UB in the C++ loop); clamp to the
    # last bin instead of silently gathering a wrong coefficient
    p1 = jnp.clip(p1, 0, 255)
    p2 = jnp.clip(p2, 0, 255)
    span = jnp.maximum(p2 + 1 - p1, 1)
    alpha = jnp.asarray(_SIMPLE_ALPHA32)[span]  # [..., 3] scalar gathers
    beta = jnp.asarray(_SIMPLE_BETA32)[p1, span]
    x = image.astype(f32)
    out = fma_f32(x, alpha[..., None, None, :], beta[..., None, None, :])
    return round_u8(out)


@partial(jax.jit, static_argnames=("thresh",))
def balance_white_grey_world(image: jax.Array, thresh: float) -> jax.Array:
    """cv::xphoto::GrayworldWB (bit-exact vs the libopencv_xphoto 4.6
    oracle): integer saturation mask, integer channel sums, gains toward the
    minimum-sum channel in 8.8 fixed point with truncating descale."""
    i32 = jnp.int32
    f32 = jnp.float32
    v = image.astype(i32)
    b, g, r = v[..., 0], v[..., 1], v[..., 2]
    mx = jnp.maximum(jnp.maximum(b, g), r)
    mn = jnp.minimum(jnp.minimum(b, g), r)
    t255 = int(np.rint(np.float32(thresh) * 255))  # cvRound at init
    if t255 <= 257:
        # t255*mx <= 257*255 < 2^16: the library's u16 SIMD lanes cannot
        # wrap, one uniform comparison
        m = (mx - mn) * 255 <= t255 * mx
    else:
        # thresh > ~1.008: the library's 16-px SIMD body computes
        # t255*mx in u16 lanes, which WRAPS for mx >= 65536/t255, while
        # the scalar tail (the last H*W % 16 pixels) compares in int —
        # so bright pixels are pseudo-randomly excluded depending on
        # position (oracle-probed round 5: 720/720 random cases exact
        # with this rule, width 16 = the oracle build's v_uint8x16)
        h_, w_ = image.shape[-3], image.shape[-2]
        n = h_ * w_
        body = np.zeros(n, bool)
        body[: (n // 16) * 16] = True
        body = jnp.asarray(body.reshape(h_, w_))
        rhs = jnp.where(body, (t255 * mx) & 0xFFFF, t255 * mx)
        m = (mx - mn) * 255 <= rhs

    # uint32 accumulation: exact for frames up to ~16.8 MP (255 * n < 2^32);
    # int32 would wrap above ~8.4 MP
    u32 = jnp.uint32
    sb = jnp.sum(jnp.where(m, b, 0).astype(u32), axis=(-2, -1))
    sg = jnp.sum(jnp.where(m, g, 0).astype(u32), axis=(-2, -1))
    sr = jnp.sum(jnp.where(m, r, 0).astype(u32), axis=(-2, -1))
    # smin over POSITIVE sums only; a zero-sum channel gets gain 0 — the
    # library blacks it out rather than passing it through (oracle-probed
    # round 5: an empty saturation mask blacks the WHOLE frame, and a
    # zero-sum channel doesn't drag smin to 0 for the live channels)
    big = jnp.uint32(0xFFFFFFFF)
    smin = jnp.minimum(
        jnp.minimum(jnp.where(sb > 0, sb, big), jnp.where(sg > 0, sg, big)),
        jnp.where(sr > 0, sr, big),
    )

    def gain_i(s):
        gi = jnp.rint(smin.astype(f32) / s.astype(f32) * f32(256.0)).astype(i32)
        return jnp.where(s > 0, gi, 0)

    gains = jnp.stack([gain_i(sb), gain_i(sg), gain_i(sr)], axis=-1)
    out = (v * gains[..., None, None, :]) >> 8
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# PCA white balance — bit-exact replica of the reference's custom method
# (white_balance.cpp:73-136), pinned against native/oracle/pca_oracle.cpp.
#
# Reference arithmetic, stage by stage:
#   1. cv::sum on the u8->f32 channels / their squares: EXACT integer sums
#     (every partial f32 add in OpenCV's 4-unrolled loop stays < 2^24
#      before reaching the double accumulator) — verified vs oracle prints.
#   2. The doubles are narrowed to f32 when filled into Eigen Matrix2f.
#   3. Eigen compute_inverse_size2 in f32: invdet = 1/(s2*m - s*m2),
#      adjugate * invdet, coefficient-wise 2x2 * 2x1 — plain rn mul/add
#      (default catkin x86-64 build: no fp contraction) — orderings
#      verified to reproduce the oracle's coefficient bits.
#   4. MatExpr  x0*C2 + x1*C  evaluates via cv::addWeighted, whose AVX2
#      32f kernel computes in DOUBLE (vfmadd132pd) and narrows once:
#      out = rn_f32(x0*c^2 + x1*c) with the f64 value EXACT (<= 42
#      significant bits), i.e. a single correct rounding of the exact
#      real. Then THRESH_TRUNC at 255 and convertTo(CV_8U) = cvRound.
#
# Design: the per-pixel map depends only on c in [0,256), so the whole
# apply is a per-frame 256-entry u8 LUT served by a select tree. The LUT
# entries need rn_f32(x0*c^2 + x1*c) with the rounding of the EXACT value
# — without f64 (disabled by default in JAX), so a small soft-float path computes it with exact
# multi-word integer arithmetic in 12-bit limbs (256 entries/frame: cost
# is noise). Sums are exact u32 split-accumulations recombined into the
# correctly rounded f32 the reference's double->float narrowing produces.
# ---------------------------------------------------------------------------


def _twosum(a, b):
    """Knuth TwoSum: s + e == a + b exactly, s = rn(a+b)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _rn_f32_split_u32(hi_sum, lo_sum):
    """Correctly rounded f32 of the exact integer hi_sum*256 + lo_sum,
    where hi_sum/lo_sum are exact u32 sums (the two halves of a split
    accumulation). Decomposes into four f32-exact terms and recombines
    with TwoSum + exact integer error accumulation."""
    f32 = jnp.float32
    hi = hi_sum
    t1 = (hi >> 16).astype(f32) * f32(1 << 24)      # (hi>>16)*2^24, exact
    t2 = (hi & 0xFFFF).astype(f32) * f32(1 << 8)    # < 2^24, exact
    t3 = (lo_sum >> 16).astype(f32) * f32(1 << 16)  # exact
    t4 = (lo_sum & 0xFFFF).astype(f32)              # exact
    s, e1 = _twosum(t1, t3)
    s, e2 = _twosum(s, t2)
    s, e3 = _twosum(s, t4)
    # errors are integers <= 3*2^15: their f32 sum is exact, and
    # s + err == total exactly => one final rounding is correct
    return s + ((e1 + e2) + e3)


def _frexp_int24(x):
    """x (f32) -> (sign, m, e) with x == sign * m * 2^(e-24), m a 24-bit
    integer in [2^23, 2^24) (m = 0 for x == 0)."""
    mant, e = jnp.frexp(x)
    m = jnp.round(jnp.abs(mant) * jnp.float32(1 << 24)).astype(jnp.int32)
    m = jnp.where(x == 0, 0, m)
    e = jnp.where(x == 0, 0, e).astype(jnp.int32)
    return jnp.sign(x).astype(jnp.float32), m, e


_PCA_LIMBS = 11  # 132 bits: 41-bit product + <=79-bit align shift + carry


def _limbs_from_pair(u, v):
    """Exact limb vector (base 2^12, _PCA_LIMBS limbs) of v*2^12 + u for
    i32 u, v < 2^28. Returns [..., L] i32 with limbs in [0, 2^12)."""
    l0 = u & 0xFFF
    l1 = ((u >> 12) & 0xFFF) + (v & 0xFFF)
    l2 = (u >> 24) + ((v >> 12) & 0xFFF)
    l3 = v >> 24
    # carry-normalize (each pre-limb < 2^13)
    c1 = l1 >> 12
    l1 = l1 & 0xFFF
    l2 = l2 + c1
    c2 = l2 >> 12
    l2 = l2 & 0xFFF
    l3 = l3 + c2
    zeros = jnp.zeros_like(l0)
    limbs = [l0, l1, l2, l3] + [zeros] * (_PCA_LIMBS - 4)
    return jnp.stack(limbs, axis=-1)


def _shift_limbs_left(limbs, nbits):
    """Shift the limb vector left by nbits (traced, per-element ok).
    nbits must leave the value within _PCA_LIMBS limbs."""
    k = nbits // 12
    r = nbits % 12
    idx = jnp.arange(_PCA_LIMBS)
    src = idx - k[..., None]                       # [..., L]
    srcc = jnp.clip(src, 0, _PCA_LIMBS - 1)
    base = jnp.take_along_axis(limbs, srcc, axis=-1)
    base = jnp.where(src >= 0, base, 0)
    srcm1 = jnp.clip(src - 1, 0, _PCA_LIMBS - 1)
    below = jnp.take_along_axis(limbs, srcm1, axis=-1)
    below = jnp.where(src - 1 >= 0, below, 0)
    r_ = r[..., None]
    hi = (base << r_) & 0xFFF
    lo = jnp.where(r_ > 0, below >> (12 - r_), 0)
    return hi | lo


def _limbs_cmp(a, b):
    """Lexicographic magnitude compare: +1 if a>b, -1 if a<b, 0 equal."""
    cmp = jnp.zeros(a.shape[:-1], jnp.int32)
    for j in range(_PCA_LIMBS - 1, -1, -1):
        sj = jnp.sign(a[..., j] - b[..., j])
        cmp = jnp.where(cmp != 0, cmp, sj)
    return cmp


def _limbs_add(a, b):
    out = []
    carry = jnp.zeros(a.shape[:-1], jnp.int32)
    for j in range(_PCA_LIMBS):
        t = a[..., j] + b[..., j] + carry
        out.append(t & 0xFFF)
        carry = t >> 12
    return jnp.stack(out, axis=-1)


def _limbs_sub(a, b):
    """a - b, requires a >= b."""
    out = []
    borrow = jnp.zeros(a.shape[:-1], jnp.int32)
    for j in range(_PCA_LIMBS):
        t = a[..., j] - b[..., j] - borrow
        borrow = (t < 0).astype(jnp.int32)
        out.append(t + (borrow << 12))
    return jnp.stack(out, axis=-1)


def _limbs_rn24(limbs, sticky_extra):
    """Round the exact limb integer to a 24-bit mantissa, half-even.
    Returns (mant f32 in [2^23, 2^24] or 0, exp2) with
    value ~= mant * 2^exp2."""
    # bit length of each limb via frexp (limbs < 2^12: exact)
    _, bl = jnp.frexp(limbs.astype(jnp.float32))
    bl = jnp.where(limbs > 0, bl, 0)
    pos = jnp.arange(_PCA_LIMBS) * 12 + bl  # bits used up to this limb
    msb = jnp.max(jnp.where(limbs > 0, pos, 0), axis=-1) - 1  # top bit index
    is_zero = jnp.all(limbs == 0, axis=-1)

    s = jnp.maximum(msb - 24, 0)  # q = floor(N / 2^s) keeps 25 bits
    k = s // 12
    r = s % 12
    idx = jnp.arange(_PCA_LIMBS)
    src = idx + k[..., None]
    srcc = jnp.clip(src, 0, _PCA_LIMBS - 1)
    base = jnp.take_along_axis(limbs, srcc, axis=-1)
    base = jnp.where(src <= _PCA_LIMBS - 1, base, 0)
    srcp1 = jnp.clip(src + 1, 0, _PCA_LIMBS - 1)
    above = jnp.take_along_axis(limbs, srcp1, axis=-1)
    above = jnp.where(src + 1 <= _PCA_LIMBS - 1, above, 0)
    r_ = r[..., None]
    shifted = (base >> r_) | jnp.where(r_ > 0, (above << (12 - r_)) & 0xFFF, 0)
    # q from the low three shifted limbs (<= 25 significant bits)
    q = shifted[..., 0] + (shifted[..., 1] << 12) + (shifted[..., 2] << 24)
    # sticky: any bit below position s
    below_mask = idx < k[..., None]
    lost_limbs = jnp.any(jnp.where(below_mask, limbs, 0) > 0, axis=-1)
    in_limb = jnp.take_along_axis(
        limbs, jnp.clip(k, 0, _PCA_LIMBS - 1)[..., None], axis=-1
    )[..., 0]
    lost_bits = jnp.where(r > 0, in_limb & ((1 << r) - 1), 0) > 0
    sticky = lost_limbs | lost_bits | sticky_extra

    guard = (q & 1).astype(bool)
    q24 = q >> 1
    # when msb < 24, s = 0 and q == N << 1? no: s = 0 -> q = N, guard is N's
    # lsb — wrong. Handle small values: if msb <= 23 the value already fits
    # 24 bits: mantissa = N, no rounding.
    small = msb <= 23
    round_up = guard & (sticky | ((q24 & 1).astype(bool)))
    q_rounded = q24 + round_up.astype(jnp.int32)
    overflowed = q_rounded == (1 << 24)
    q_rounded = jnp.where(overflowed, 1 << 23, q_rounded)
    exp_big = jnp.where(overflowed, msb - 22, msb - 23)

    n_small = q  # s==0: q == N (full value, <= 2^25? msb<=23 -> N < 2^24)
    mant = jnp.where(small, n_small, q_rounded).astype(jnp.float32)
    exp2 = jnp.where(small, 0, exp_big)
    mant = jnp.where(is_zero, 0.0, mant)
    return mant, exp2


def _pca_exact_lut(x0, x1):
    """256-entry u8 LUT of c -> cvRound(min(rn_f32(x0*c^2 + x1*c), 255))
    with rn_f32 of the EXACT real value (the oracle's f64-fma-then-narrow
    semantics), computed with exact integer limb arithmetic.

    x0, x1: f32 scalars with leading batch dims [...]. Returns [..., 256]
    uint8."""
    c = jnp.arange(256, dtype=jnp.int32)
    c2 = c * c
    sg0, m0, e0 = _frexp_int24(x0)
    sg1, m1, e1 = _frexp_int24(x1)
    # exact products as i32 pairs (value = v*2^12 + u)
    uA = (m0[..., None] & 0xFFF) * c2     # < 2^28
    vA = (m0[..., None] >> 12) * c2       # < 2^28
    uB = (m1[..., None] & 0xFFF) * c      # < 2^20
    vB = (m1[..., None] >> 12) * c        # < 2^20
    A = _limbs_from_pair(uA, vA)          # scale 2^(e0-24)
    B = _limbs_from_pair(uB, vB)          # scale 2^(e1-24)

    emin = jnp.minimum(e0, e1)
    dA = (e0 - emin)[..., None] * jnp.ones_like(c)  # broadcast [..., 256]
    dB = (e1 - emin)[..., None] * jnp.ones_like(c)
    # cap the alignment shift: beyond 79 bits the small term only matters
    # as a sticky bit (relative gap > 48 bits >> the 25-bit round window)
    cap = 12 * _PCA_LIMBS - 41 - 2
    a_nonzero = jnp.any(A > 0, axis=-1)
    b_nonzero = jnp.any(B > 0, axis=-1)
    sticky_extra = ((dA > cap) & b_nonzero) | ((dB > cap) & a_nonzero)
    # when the shift is capped, drop the now-insignificant small term
    B = jnp.where(((dA > cap) & b_nonzero)[..., None], 0, B)
    A = jnp.where(((dB > cap) & a_nonzero)[..., None], 0, A)
    A = _shift_limbs_left(A, jnp.minimum(dA, cap))
    B = _shift_limbs_left(B, jnp.minimum(dB, cap))

    sg0 = (sg0[..., None] * jnp.ones_like(c, jnp.float32))  # [..., 256]
    sg1 = (sg1[..., None] * jnp.ones_like(c, jnp.float32))
    same_sign = (sg0 * sg1 >= 0) | (~a_nonzero) | (~b_nonzero)
    total_add = _limbs_add(A, B)
    cmp = _limbs_cmp(A, B)
    big = jnp.where((cmp >= 0)[..., None], A, B)
    small = jnp.where((cmp >= 0)[..., None], B, A)
    total_sub = _limbs_sub(big, small)
    total = jnp.where(same_sign[..., None], total_add, total_sub)
    # result sign: dominant term's sign (a-term sign where |A|>=|B|)
    sgA = jnp.where(a_nonzero, sg0, sg1)  # A zero -> B's sign
    sgB = jnp.where(b_nonzero, sg1, sg0)
    sign = jnp.where(same_sign,
                     jnp.where(a_nonzero, sg0, sg1),
                     jnp.where(cmp >= 0, sgA, sgB))

    mant, exp2 = _limbs_rn24(total, sticky_extra)
    val = sign * jnp.ldexp(mant, exp2 + (emin[..., None] - 24))
    val = jnp.minimum(val.astype(jnp.float32), jnp.float32(255.0))
    return round_u8(val)


def _lut_select_batched(idx, table):
    """Per-frame 256-entry u8 LUT served by a binary select tree (no
    gather): idx [..., H, W] int32, table [..., 256] -> [..., H, W]."""
    cur = [table[..., i][..., None, None] for i in range(256)]
    level = 0
    while len(cur) > 1:
        b = (idx >> level) & 1
        cur = [jnp.where(b == 0, cur[i], cur[i + 1])
               for i in range(0, len(cur), 2)]
        level += 1
    return cur[0]


@jax.jit
def balance_white_pca(image: jax.Array) -> jax.Array:
    """Bit-exact replica of the reference PCA method
    (white_balance.cpp:73-136) — see the block comment above for the
    reference-arithmetic derivation and native/oracle/pca_oracle.cpp for
    the pinning oracle. Exact for frames up to 16.8 MP (u32 split sums).

    Degenerate frames (det == 0: constant channel) replicate the
    reference's NaN flow exactly, including the positional minps-vs-scalar
    THRESH_TRUNC split (255 everywhere, 0 on the last (H*W)%4 pixels) —
    see the block in the body."""
    f32 = jnp.float32
    u32 = jnp.uint32
    v = image.astype(jnp.int32)
    b, g, r = v[..., 0], v[..., 1], v[..., 2]

    def reductions(c):
        c2 = c * c
        hi = jnp.sum((c2 >> 8).astype(u32), axis=(-2, -1))
        lo = jnp.sum((c2 & 255).astype(u32), axis=(-2, -1))
        s2 = _rn_f32_split_u32(hi, lo)              # rn_f32(sum c^2)
        s = jnp.sum(c.astype(u32), axis=(-2, -1)).astype(f32)
        m = jnp.max(c, axis=(-2, -1)).astype(f32)
        return s2, s, m * m, m                      # m2 = m^2 exact

    def solve(c):
        # Eigen compute_inverse_size2 orderings, verified vs the oracle.
        # Every mul feeding an add/sub is SEALED (ops/common.seal_f32):
        # XLA:CPU's LLVM backend contracts e.g. i00*sg + i01*mg into an
        # fma whose single rounding flips x0/x1 by one ulp vs Eigen's
        # plain chain — found by the round-5 extended fuzz as a 1-LSB
        # output divergence at two LUT entries on a real frame (the
        # eager/oracle bits were 0x...46/0x...6c, the jitted ones one ulp
        # below).
        s2, s, m2, m = reductions(c)
        # runtime zero the compiler cannot fold: every pca input is
        # integer-derived, so (x != x) zeros are PROVABLY false to LLVM
        # (uitofp never yields NaN) and such a seal dissolves — but it
        # cannot prove 1/x finite (x==0 gives inf, inf-inf NaN), so
        # q - q below survives as an unprovable runtime zero. det==0
        # (a constant channel) is the reference's own UB, see docstring.
        d = s2 * m - s * m2
        q = f32(1.0) / d
        # q - q is +0 for every non-degenerate frame but NaN when det==0
        # (q inf) — which would corrupt the seal's XOR. The where pins the
        # degenerate case to a true zero so the sealed chain below
        # honestly produces the reference's inf/NaN flow there; LLVM
        # still cannot fold the non-degenerate branch (1/d unprovably
        # finite), so the seal survives.
        z = jnp.where(jnp.abs(d) < f32(1e-30), f32(0.0), q - q)
        rt0 = jax.lax.bitcast_convert_type(z, jnp.int32)
        det = seal_f32(s2 * m, rt0) - seal_f32(s * m2, rt0)
        invdet = f32(1.0) / det
        i00 = m * invdet
        i01 = -(s * invdet)
        i10 = -(m2 * invdet)
        i11 = s2 * invdet
        x0 = seal_f32(i00 * sg, rt0) + seal_f32(i01 * mg, rt0)
        x1 = seal_f32(i10 * sg, rt0) + seal_f32(i11 * mg, rt0)
        return x0, x1

    sg = jnp.sum(g.astype(u32), axis=(-2, -1)).astype(f32)
    mg = jnp.max(g, axis=(-2, -1)).astype(f32)

    # Degenerate frames (det==0: a constant channel; or subnormal det):
    # the reference's solve yields NaN coefficients, its THRESH_TRUNC
    # min runs 4-wide minps whose NaN result is the SECOND operand (255)
    # while the scalar tail keeps NaN, and convertTo saturates NaN to 0 —
    # so a NaN channel becomes 255 everywhere except the last (H*W)%4
    # pixels, which are 0 (characterized against native/oracle/pca_oracle
    # at 3x3/5x5/8x8/9x7/16x16; round 5).
    h_, w_ = image.shape[-3], image.shape[-2]
    tail = (h_ * w_) % 4
    flat_pat = np.full(h_ * w_, 255, np.uint8)
    if tail:
        flat_pat[-tail:] = 0
    nan_pattern = jnp.asarray(flat_pat.reshape(h_, w_))

    def corrected(c):
        x0, x1 = solve(c)
        out = _lut_select_batched(c, _pca_exact_lut(x0, x1))
        bad = jnp.isnan(x0) | jnp.isnan(x1)          # per-frame scalar
        return jnp.where(bad[..., None, None], nan_pattern, out)

    bb = corrected(b)
    rr = corrected(r)
    return jnp.stack([bb, g.astype(jnp.uint8), rr], axis=-1)


def balance_white_learned(image: jax.Array, thresh: float) -> jax.Array:
    """cv::xphoto::LearningBasedWB with the REAL default model
    (reference: modules/white_balance.cpp:66-71 passes
    saturation_bright_thr as the saturation threshold).

    Full implementation — extracted tree ensemble + reverse-engineered
    simple-feature extraction — lives in ops/learned_wb.py; verified
    bit-exact against the native libopencv_xphoto on the reference
    fixtures (tests/test_learned_wb.py).
    """
    from raw_image_pipeline_tpu.ops.learned_wb import balance_white_learned_model

    return balance_white_learned_model(image, thresh)
