"""cv::xphoto::LearningBasedWB — the real model, in JAX.

The reference calls createLearningBasedWB("") (modules/white_balance.cpp:
66-71), which uses a default model compiled into OpenCV. This module
implements the full algorithm with that exact model:

  * model: 160 depth-4 regression trees (15 internal nodes + 16 leaves
    each), organized as 20 tree-sets x 4 features x 2 chromaticity
    components; weights extracted from libopencv_xphoto 4.6
    (Apache-2.0) into models/data/learned_wb_default.npz;
  * features (Cheng et al., CVPR 2015 "simple features"), semantics
    reverse-engineered against the native library and verified bit-exact
    on the reference fixtures (tests/test_learned_wb.py):
      f0: chromaticity of the average unsaturated color — means in
          DOUBLE (cv::mean), divided by the max mean in double, narrowed
          to f32 (emulated with sealed double-f32 Dekker arithmetic);
      f1: chromaticity of the brightest unsaturated pixel (max B+G+R;
          ties: the library's 8-lane SIMD loop + scalar tail, all
          first-wins — minimal (flat%8, flat//8) among body pixels,
          tail only beats strictly);
      f2: chromaticity of the dominant bin of a 64^3 histogram over
          [0, max(64, max_pixel_value)) of unsaturated pixels (argmax,
          first in (B,G,R)-scan order), computed from BIN INDICES;
      f3: mode of the top-300-bin color palette under an unweighted
          Epanechnikov KDE with bandwidth 0.1 (ties: first in palette
          order). CAVEAT: which bins survive the top-300 cut among
          EQUAL-COUNT bins follows the library's std::sort order, which
          is unspecified and input-dependent (empirically: a crafted
          all-tied palette matched stable-ascending, but a 159x713
          natural crop matched descending, and no channel-major stable
          order explains both). We use the deterministic
          (count desc, bin asc) rule; when the library's unstable order
          admits different members at the cutoff, the KDE mode — and
          hence the gains — can shift (measured: 1 of 20 random fixture
          crops, <=7 LSB output);
    every chromaticity is (r, g) = (R, G)/(((R+G)+B) + 1e-5);
  * inference: per tree-set, predict (u, v) per feature; a set reaches
    consensus when >2 of the 6 pairwise distances among its 4 predictions
    are < prediction_thresh (0.025); the result is the per-component
    UPPER median (index n//2 of the sorted values) over all predictions
    of consensus sets, falling back to the median over all 80
    predictions when no set agrees;
  * gains: illuminant (u, v, 1-u-v) for (R, G, B); per-channel gain
    min(illum)/illum_c applied in 8.8 fixed point with truncating
    descale (identical to the grayworld path).

Saturation mask: pixel kept iff max(B,G,R) < trunc(saturation_thresh *
range_max_val) (default 0.98*255 -> 249).

f0-f2 verified bit-exact against the native library over 50 random
frames (round 5); f3 carries the palette-cut envelope above, plus
library-side uninitialized reads on frames with <300 color runs.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_MODEL_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "models", "data",
    "learned_wb_default.npz",
)

_HIST_BINS = 64
_PALETTE = 300
_BANDWIDTH = 0.1
_PRED_THRESH = 0.025
_EPS = np.float32(1e-5)
_N_SETS = 20
_DEPTH = 4


def _load_model():
    d = np.load(_MODEL_PATH)
    fi = d["feature_idx"].reshape(160, 15).astype(np.int32)
    tv = d["thresh_vals"].reshape(160, 15).astype(np.float32)
    lv = d["leaf_vals"].reshape(160, 16).astype(np.float32)
    return fi, tv, lv


_FI, _TV, _LV = _load_model()


def _trees_predict(features_uv: jax.Array) -> jax.Array:
    """features_uv: [4, 2] f32 -> [20, 4, 2] per-set/per-feature (u, v).

    Tree t = s*8 + i*2 + k predicts component k of feature i in set s.
    The descent is 4 unrolled levels of tiny (160-wide) gathers on the
    host-constant model arrays.
    """
    fi = jnp.asarray(_FI)  # [160, 15]
    tv = jnp.asarray(_TV)
    lv = jnp.asarray(_LV)  # [160, 16]
    # per-tree input component values: tree t uses feature i = (t % 8) // 2
    feat_of_tree = jnp.asarray((np.arange(160) % 8) // 2, jnp.int32)
    x = features_uv[feat_of_tree]  # [160, 2]

    node = jnp.zeros((160,), jnp.int32)
    ar = jnp.arange(160)
    for _ in range(_DEPTH):
        f = fi[ar, node]  # [160]
        th = tv[ar, node]
        val = jnp.where(f == 0, x[:, 0], x[:, 1])
        node = jnp.where(val <= th, 2 * node + 1, 2 * node + 2)
    leaves = lv[ar, node - 15]  # [160]
    return leaves.reshape(_N_SETS, 4, 2)


def _predict_illuminant(features_uv: jax.Array) -> jax.Array:
    """[4, 2] features -> [2] illuminant (u, v): consensus + upper median."""
    preds = _trees_predict(features_uv)  # [20, 4, 2]
    # pairwise distances within each set
    d = preds[:, :, None, :] - preds[:, None, :, :]  # [20, 4, 4, 2]
    dist = jnp.sqrt(jnp.sum(d * d, -1))
    iu = jnp.triu_indices(4, 1)
    agree = (dist[:, iu[0], iu[1]] < _PRED_THRESH).sum(-1)  # [20]
    consensus = agree > 2  # [20]
    any_cons = jnp.any(consensus)

    flat = preds.reshape(80, 2)
    w = jnp.repeat(consensus, 4)  # [80]

    def upper_median(vals, mask, n_sel):
        # median over selected entries: sort with unselected pushed to +inf,
        # take index n_sel // 2
        s = jnp.sort(jnp.where(mask, vals, jnp.inf))
        return s[(n_sel // 2).astype(jnp.int32)]

    n_cons = w.sum()
    u_c = upper_median(flat[:, 0], w, n_cons)
    v_c = upper_median(flat[:, 1], w, n_cons)
    u_a = jnp.sort(flat[:, 0])[40]
    v_a = jnp.sort(flat[:, 1])[40]
    return jnp.where(
        any_cons, jnp.stack([u_c, v_c]), jnp.stack([u_a, v_a])
    )


def _chroma(r, g, b):
    # library sum order ((r+g)+b)+eps — only visible for f0, whose inputs
    # are non-integer f32 (f1-f3 sum exact small integers where order
    # can't change the rounding); round-5 fit: 20/20 vs 18/20 for (b+g)+r
    s = r + g + b + _EPS
    return jnp.stack([r / s, g / s]).astype(jnp.float32)


def _extract_features(image: jax.Array, thresh255: int) -> jax.Array:
    """[H, W, 3] u8 BGR -> [4, 2] f32 features."""
    f32 = jnp.float32
    B = image[..., 0].astype(jnp.int32)
    G = image[..., 1].astype(jnp.int32)
    R = image[..., 2].astype(jnp.int32)
    mx = jnp.maximum(jnp.maximum(B, G), R)
    keep = mx < thresh255
    n = jnp.maximum(keep.sum(), 1)

    # f0: average chromaticity of normalized colors. The library computes
    # the channel means in DOUBLE (cv::mean), divides by the max mean in
    # double, narrows the normalized components to f32 and runs the f32
    # eps-chroma — reverse-engineered round 5 (20/20 random frames
    # bit-equal; the max-normalization is also why f0 sits a constant
    # ~3.4e-6 below an un-normalized chroma: with s ~= 3 the 1e-5 eps
    # scales differently). The f64 scalar chain is emulated with
    # double-f32 (Dekker) arithmetic (~2^-46 accuracy vs f64's 2^-52 —
    # a narrow-boundary flip needs the exact value within 2^-46 of an
    # f32 rounding boundary, ~2^-22 odds per frame; none seen over the
    # 130-frame sweep).
    nf = n.astype(f32)

    # exact channel sums in u32 (exact to 16.8 MP like pca's), lifted to
    # dd: hi = f32(S) (rounds to <=256 granularity near 2^32), lo = the
    # small signed remainder recovered through wrapping u32 arithmetic
    sums_u32 = [jnp.sum(jnp.where(keep, C, 0).astype(jnp.uint32)) for C in (B, G, R)]

    # seal zero for the Dekker arithmetic below: LLVM contracts the
    # mul+sub chains into fmas, which breaks the exact splits (observed:
    # 1-ulp f0 flips on ~8% of frames vs the eager/f64 chain). The zero
    # must be UNPROVABLE (ops/common.seal_f32): 1/sum can be inf (empty
    # channel), and the where pins that case to a true zero.
    sb32 = sums_u32[0].astype(f32)
    qz = f32(1.0) / sb32
    z = jnp.where(sb32 < f32(0.5), f32(0.0), qz - qz)
    rt0 = jax.lax.bitcast_convert_type(z, jnp.int32)

    def sl(v):
        from raw_image_pipeline_tpu.ops.common import seal_f32

        return seal_f32(v, rt0)

    def fma_sealed(a, b, c):
        # rn(a*b + c), Dekker 2Product + TwoSum with every mul that feeds
        # an add/sub sealed against contraction
        C4 = f32(4097.0)
        ca = sl(a * C4)
        ahi2 = ca - (ca - a)
        alo2 = a - ahi2
        cb = sl(b * C4)
        bhi2 = cb - (cb - b)
        blo2 = b - bhi2
        p = sl(a * b)
        err = (((sl(ahi2 * bhi2) - p) + sl(ahi2 * blo2)) + sl(alo2 * bhi2)) + sl(
            alo2 * blo2
        )
        s = p + c
        bb = s - p
        e2 = (p - (s - bb)) + (c - bb)
        return s + (e2 + err)

    def dd_div_s(ahi, alo, b):
        # (ahi+alo)/b to ~2^-46: q0 + correction
        q0 = ahi / b
        r = fma_sealed(-q0, b, ahi) + alo  # exact residual of q0*b
        q1 = r / b
        return q0, q1

    def dd_div_dd(ahi, alo, bhi, blo):
        q0 = ahi / bhi
        r = (fma_sealed(-q0, bhi, ahi) + alo) - sl(q0 * blo)
        q1 = r / bhi
        return q0, q1

    def dd_ge(ahi, alo, bhi, blo):
        return (ahi > bhi) | ((ahi == bhi) & (alo >= blo))

    dd_means = []
    for si in sums_u32:
        s32 = si.astype(f32)
        lo = (si - s32.astype(jnp.uint32)).astype(jnp.int32).astype(f32)
        dd_means.append(dd_div_s(s32, lo, nf))
    (mbh, mbl), (mgh, mgl), (mrh, mrl) = dd_means
    # dd max of the three means
    m1h, m1l = jnp.where(dd_ge(mbh, mbl, mgh, mgl), mbh, mgh), jnp.where(
        dd_ge(mbh, mbl, mgh, mgl), mbl, mgl
    )
    mmh, mml = jnp.where(dd_ge(m1h, m1l, mrh, mrl), m1h, mrh), jnp.where(
        dd_ge(m1h, m1l, mrh, mrl), m1l, mrl
    )
    zero_mm = mmh <= 0  # all-black kept set: skip normalization
    mmh = jnp.where(zero_mm, f32(1.0), mmh)
    mml = jnp.where(zero_mm, f32(0.0), mml)

    def narrow(dd):
        return dd[0] + dd[1]  # one f32 rounding = the f64->f32 narrow

    nb = narrow(dd_div_dd(mbh, mbl, mmh, mml))
    ng = narrow(dd_div_dd(mgh, mgl, mmh, mml))
    nr = narrow(dd_div_dd(mrh, mrl, mmh, mml))
    f0 = _chroma(nr, ng, nb)

    # f1: brightest unsaturated pixel. The library's max scan is an
    # 8-lane SIMD loop over the flattened frame with a scalar tail, all
    # first-wins (`>`): per lane the FIRST block keeps the max, the
    # horizontal reduce scans lanes 0..7 in order, and tail pixels only
    # beat strictly. Net tie-break among max-sum pixels: minimal
    # (lane = flat%8, block = flat//8) for body pixels, then tail by
    # position (reverse-engineered round 5 with positional probe frames
    # — the earlier "last max" rule fit one fixture by accident and
    # broke on others; this rule fits every probe, incl. the fixture)
    sums = jnp.where(keep, B + G + R, -1).reshape(-1)
    n_px_f1 = sums.shape[0]
    body_n = (n_px_f1 // 8) * 8
    rank_np = np.empty(n_px_f1, np.int32)
    c = 0
    for lane in range(8):
        li = np.arange(lane, body_n, 8)
        rank_np[li] = np.arange(c, c + li.size, dtype=np.int32)
        c += li.size
    rank_np[body_n:] = np.arange(c, n_px_f1, dtype=np.int32)
    rank = jnp.asarray(rank_np)
    msum = jnp.max(sums)
    at_max = sums == msum
    rmin = jnp.min(jnp.where(at_max, rank, jnp.int32(2**31 - 1)))
    bi = jnp.argmax(at_max & (rank == rmin))
    # fully-saturated frames keep NO pixel: the library's scan never
    # updates and f1 stays at its zero init (oracle-verified); without
    # the guard the reversed argmax would read a saturated pixel. (The
    # library's f0 is 0/0 = NaN there — degenerate UB we replace with
    # zero features rather than NaN-feeding the trees.)
    any_kept = sums[bi] >= 0
    fb = jnp.where(any_kept, B.reshape(-1)[bi], 0).astype(f32)
    fg = jnp.where(any_kept, G.reshape(-1)[bi], 0).astype(f32)
    fr = jnp.where(any_kept, R.reshape(-1)[bi], 0).astype(f32)
    f1 = _chroma(fr, fg, fb)

    # 64^3 histogram over [0, max(64, maxval)) of kept pixels (bin ids via
    # sort + run-length counts — scatter-free)
    maxval = jnp.max(mx)
    hi = jnp.maximum(maxval, _HIST_BINS).astype(f32)

    def bidx(v):
        i = jnp.floor(v.astype(f32) * f32(_HIST_BINS) / hi).astype(jnp.int32)
        return jnp.clip(i, 0, _HIST_BINS - 1)

    bid = (bidx(B) * _HIST_BINS + bidx(G)) * _HIST_BINS + bidx(R)
    bid = jnp.where(keep, bid, _HIST_BINS ** 3).reshape(-1)  # masked -> sentinel
    s = jnp.sort(bid)
    n_px = s.shape[0]
    pos = jnp.arange(n_px)
    start = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    # run length at each run start = (position of next start) - position;
    # next-start-after via a reversed cummin over start positions
    nxt = jnp.where(start, pos, n_px)
    suffix_min = jax.lax.cummin(nxt[::-1], axis=0)[::-1]  # min start >= i
    next_after = jnp.concatenate([suffix_min[1:], jnp.full((1,), n_px)])
    counts = jnp.where(start & (s < _HIST_BINS ** 3), next_after - pos, 0)

    # dominant: first (scan-order = ascending bin id = sorted order) run
    # with the maximum count
    ci = jnp.argmax(counts)  # argmax returns first max ✓ (sorted ascending)
    dom = s[ci]
    db = (dom // (_HIST_BINS * _HIST_BINS)).astype(f32)
    dg = ((dom // _HIST_BINS) % _HIST_BINS).astype(f32)
    dr = (dom % _HIST_BINS).astype(f32)
    f2 = _chroma(dr, dg, db)

    # palette: top-300 runs by (count desc, bin id asc) — top_k is stable
    # on index order and the runs are bin-id-ascending. Frames under 300
    # pixels have fewer runs than the palette: take what exists and pad
    # with zero-count entries (valid=False keeps them inert downstream)
    k = min(_PALETTE, int(counts.shape[0]))
    topc, topi = jax.lax.top_k(counts, k)
    if k < _PALETTE:
        topc = jnp.pad(topc, (0, _PALETTE - k))
        topi = jnp.pad(topi, (0, _PALETTE - k))
    pbin = s[topi]
    valid = topc > 0
    pb = (pbin // (_HIST_BINS * _HIST_BINS)).astype(f32)
    pg = ((pbin // _HIST_BINS) % _HIST_BINS).astype(f32)
    pr = (pbin % _HIST_BINS).astype(f32)
    ps = pb + pg + pr + _EPS
    pu = (pr / ps).astype(f32)
    pv = (pg / ps).astype(f32)
    du = pu[:, None] - pu[None, :]
    dv = pv[:, None] - pv[None, :]
    ker = jnp.maximum(
        f32(0.0), f32(1.0) - (du * du + dv * dv) / f32(_BANDWIDTH ** 2)
    )
    ker = ker * (valid[:, None] & valid[None, :])
    dens = jnp.where(valid, ker.sum(1), -jnp.inf)
    mi = jnp.argmax(dens)
    f3 = jnp.stack([pu[mi], pv[mi]])

    return jnp.stack([f0, f1, f2, f3])  # [4, 2]


@partial(jax.jit, static_argnames=("thresh255",))
def _learned_one(image: jax.Array, thresh255: int) -> jax.Array:
    feats = _extract_features(image, thresh255)
    uv = _predict_illuminant(feats)
    u, v = uv[0], uv[1]
    illum = jnp.stack([1.0 - u - v, v, u])  # B, G, R
    illum = jnp.maximum(illum, 1e-6)
    gains = jnp.min(illum) / illum
    gi = jnp.rint(gains.astype(jnp.float32) * 256.0).astype(jnp.int32)
    out = (image.astype(jnp.int32) * gi[None, None, :]) >> 8
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


def balance_white_learned_model(image: jax.Array, saturation_thresh: float = 0.98) -> jax.Array:
    """[..., H, W, 3] u8 BGR -> balanced, using the real LearningBasedWB
    model (reference: modules/white_balance.cpp:66-71). Batched over
    leading axes via vmap."""
    thresh255 = int(np.trunc(np.float32(saturation_thresh) * 255))
    lead = image.shape[:-3]
    flat = image.reshape((-1,) + image.shape[-3:])
    out = jax.vmap(lambda im: _learned_one(im, thresh255))(flat)
    return out.reshape(image.shape)
