"""Exact small-table lookups without gathers.

Every table here is generated by an arithmetic formula (pow, division,
sRGB curve), so instead of a per-pixel gather we evaluate the formula per
pixel and patch the few entries where the device's float arithmetic
rounds differently from the reference table — corrections derived *on the
executing platform* at build time by evaluating the formula over the whole
(tiny) domain and diffing against the exact host table. The patched lookup
is bit-exact by construction and costs a handful of arithmetic ops plus
<=MAX_CORR equality-selects per pixel. (This design was chosen for an
accelerator whose gathers ran at scalar rate; whether a plain table gather
is faster on the H100 is not measured yet.)
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

MAX_CORR = 32


def current_platform() -> str:
    """Platform that arrays and jitted calls made now default to: the
    device of an enclosing `jax.default_device(...)`, else the default
    backend. Per-platform corrections are keyed on this, so a CPU and a
    GPU pipeline built in one process each get their own list
    (jax.default_backend() alone reports the GPU even inside
    `jax.default_device(cpu)`)."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def derive_corrections(
    formula: Callable[[jax.Array], jax.Array],
    exact_table: np.ndarray,
    max_corr: int = MAX_CORR,
    pad: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Evaluate `formula` over arange(len(exact_table)) on the current
    default device (see current_platform) and return (idx, val)
    correction arrays.

    With pad=True the arrays are padded to max_corr with idx=-1 (stable
    pytree shapes for runtime parameters); with pad=False they are exactly
    the mismatch count long — use for trace-time constants so the
    equality-select chain is only as deep as the real correction count
    (a -1 pad entry still costs a compare+select per pixel per use).
    """
    n = len(exact_table)
    # may be invoked while an outer jit is tracing (lazy per-backend
    # derivation) — force concrete evaluation
    with jax.ensure_compile_time_eval():
        xs = jnp.arange(n, dtype=jnp.int32)
        got = np.asarray(jax.jit(formula)(xs))
    mism = np.nonzero(got != exact_table)[0]
    if len(mism) > max_corr:
        raise ValueError(
            f"formula mismatches table at {len(mism)} > {max_corr} entries; "
            "formula is too inaccurate for sparse correction"
        )
    size = max_corr if pad else len(mism)
    idx = np.full(size, -1, np.int32)
    val = np.zeros(size, np.asarray(exact_table).dtype)
    idx[: len(mism)] = mism
    val[: len(mism)] = exact_table[mism]
    return idx, val


def apply_corrected(
    x: jax.Array,
    formula: Callable[[jax.Array], jax.Array],
    corr_idx,
    corr_val,
) -> jax.Array:
    """y = formula(x), then y[x == corr_idx[j]] = corr_val[j]."""
    y = formula(x)
    for j in range(len(corr_idx)):
        y = jnp.where(x == corr_idx[j], corr_val[j], y)
    return y


def fit_branch_poly(
    n_total: int,
    idx: np.ndarray,
    target_f64: np.ndarray,
    budget: int = 6,
    degrees=range(4, 26),
    root: int = 2,
):
    """Host-side (init-time) Chebyshev fit of a smooth table branch.

    Transcendentals (pow, cbrt) cost tens of ops each; every smooth curve
    these tables serve fits a low-degree polynomial in (i/(n-1))^(1/root)
    space (root=2 absorbs x^p singularities down to p~0.5, root=3 down to
    p~0.33) whose f32 Horner evaluation is 2 ops per degree. Fitting
    targets the UNROUNDED f64 curve; callers rint/clip on device and the
    CorrectedTable machinery patches any
    residual rounding differences per backend, so bit-exactness is
    unaffected by the approximation.

    Returns (coeffs_f32 highest-first, lo, hi) for the smallest degree whose
    host-emulated f32 Horner matches rint(target) except at <= budget
    points, or None if none does.
    """
    idx = np.asarray(idx, np.float64)
    u = np.power(idx / (n_total - 1), 1.0 / root)
    lo, hi = float(u.min()), float(u.max())
    t = 2.0 * (u - lo) / (hi - lo) - 1.0
    # budget screening emulates poly_eval's f32 arithmetic STEP FOR STEP
    # (f32 scale, f32 root, f32 affine) so the host mismatch count bounds
    # the device count up to backend rounding differences, which the
    # correction machinery absorbs
    f32 = np.float32
    uf = (idx.astype(f32) * f32(1.0 / (n_total - 1))).astype(f32)
    if root == 2:
        uf = np.sqrt(uf, dtype=f32)
    elif root == 3:
        uf = np.cbrt(uf, dtype=f32)
    elif root != 1:
        uf = np.power(uf, f32(1.0 / root), dtype=f32)
    tf = ((uf - f32(lo)) * f32(2.0 / (hi - lo)) - f32(1.0)).astype(f32)
    from numpy.polynomial import chebyshev as _cheb

    want = np.rint(target_f64)
    for d in degrees:
        cf = _cheb.chebfit(t, target_f64, d)
        co = _cheb.cheb2poly(cf)[::-1].astype(np.float32)
        acc = np.full_like(tf, co[0], dtype=np.float32)
        for c in co[1:]:
            acc = (acc * tf + np.float32(c)).astype(np.float32)
        if int((np.rint(acc.astype(np.float64)) != want).sum()) <= budget:
            return co, lo, hi
    return None


def poly_eval(i: jax.Array, coeffs, lo: float, hi: float, n_total: int,
              root: int = 2) -> jax.Array:
    """Device f32 Horner evaluation of a fit_branch_poly result at integer
    index i. coeffs may be a numpy constant or a runtime jax array (fixed
    length; leading zeros are harmless pad)."""
    f32 = jnp.float32
    u = i.astype(f32) * f32(1.0 / (n_total - 1))
    if root == 2:
        u = jnp.sqrt(u)  # hardware rsqrt-based, cheap
    elif root == 3:
        u = jnp.cbrt(u)  # native; absorbs x^k singularities for k < ~0.5
    elif root != 1:
        u = jnp.power(u, f32(1.0 / root))
    t = (u - f32(lo)) * f32(2.0 / (hi - lo)) - f32(1.0)
    if isinstance(coeffs, np.ndarray):  # trace-time constants — fold
        acc = jnp.full(t.shape, f32(coeffs[0]))
        rest = [f32(c) for c in coeffs[1:]]
    else:  # runtime parameter vector (fixed length)
        acc = jnp.broadcast_to(coeffs[0].astype(f32), t.shape)
        rest = [coeffs[j].astype(f32) for j in range(1, coeffs.shape[0])]
    for c in rest:
        acc = acc * t + c
    return acc


class CorrectedTable:
    """A fixed exact table served by formula + per-platform corrections.

    Corrections are derived lazily once per platform (CPU and GPU
    transcendentals round differently, so each gets its own patch list).
    """

    def __init__(self, formula: Callable, exact_table: np.ndarray,
                 max_corr: int = MAX_CORR):
        self.formula = formula
        self.exact = np.asarray(exact_table)
        self.max_corr = max_corr
        self._corr: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    def _corrections(self):
        platform = current_platform()
        if platform not in self._corr:
            self._corr[platform] = derive_corrections(
                self.formula, self.exact, self.max_corr, pad=False
            )
        return self._corr[platform]

    def __call__(self, x: jax.Array) -> jax.Array:
        idx, val = self._corrections()
        return apply_corrected(x, self.formula, idx, val)
