"""Shared fixed-point helpers matching OpenCV integer conventions."""

from __future__ import annotations

import jax
import jax.numpy as jnp


def descale(x, n: int):
    """OpenCV CV_DESCALE: (x + (1 << (n-1))) >> n (round half up for x>=0)."""
    return (x + (1 << (n - 1))) >> n


def avg2(a, b):
    """(a + b + 1) >> 1 in integer dtype (OpenCV bilinear demosaic rounding)."""
    return (a + b + 1) >> 1


def avg4(a, b, c, d):
    """(a + b + c + d + 2) >> 2 (OpenCV bilinear demosaic rounding)."""
    return (a + b + c + d + 2) >> 2


def saturate_u8(x):
    """Clamp an integer/float array to [0, 255] and cast to uint8."""
    return jnp.clip(x, 0, 255).astype(jnp.uint8)


def round_u8(x):
    """OpenCV saturate_cast<uchar>(float): rint (half-to-even) then clamp.

    jnp.rint uses round-half-to-even, same as cvRound on x86.
    """
    return jnp.clip(jnp.rint(x), 0, 255).astype(jnp.uint8)


def fma_f32(a, b, c):
    """rnd32(a*b + c) with a SINGLE rounding — an emulated fused
    multiply-add built from plain f32 mul/add/sub (Dekker 2Product + TwoSum),
    reproducible on backends without an exposed fma primitive.

    Used where OpenCV's SIMD kernels compute with real fmas and the 1-LSB
    parity depends on the single-rounding semantics. The residual
    double-rounding window of the emulation is ~2^-48 relative — far below
    any u8-visible boundary.
    """
    f32 = jnp.float32
    a = jnp.asarray(a, f32)
    b = jnp.asarray(b, f32)
    c = jnp.asarray(c, f32)
    C = f32(4097.0)  # 2^12 + 1 Dekker split constant
    ca = a * C
    ahi = ca - (ca - a)
    alo = a - ahi
    cb = b * C
    bhi = cb - (cb - b)
    blo = b - bhi
    p = a * b
    err = (((ahi * bhi - p) + ahi * blo) + alo * bhi) + alo * blo
    # TwoSum(p, c) — branch-free exact error of the rounded sum
    s = p + c
    bb = s - p
    e2 = (p - (s - bb)) + (c - bb)
    return s + (e2 + err)


def lut_select(idx, table):
    """table[idx] via a binary select tree instead of a gather.

    A log2(n)-deep tree of elementwise selects on the index bits fuses
    into a single elementwise pass (chosen where gathers ran at scalar
    rate; whether a gather is faster on the H100 is not measured yet).
    `table` may be a traced array (each entry becomes a traced scalar), so
    LUT contents stay runtime parameters — no recompile when values change.

    idx: integer array, values in [0, len(table)); table: 1-D, length a
    power of two (pad with the last entry if needed).
    """
    n = table.shape[0]
    assert n & (n - 1) == 0, f"table length {n} must be a power of two"
    cur = [table[i] for i in range(n)]
    level = 0
    while len(cur) > 1:
        b = (idx >> level) & 1
        cur = [jnp.where(b == 0, cur[i], cur[i + 1]) for i in range(0, len(cur), 2)]
        level += 1
    return cur[0]


def seal_f32(v, rt_zero_i32):
    """Pin a f32 intermediate against compiler fma contraction.

    XLA:CPU's LLVM backend contracts mul+add chains into fmas, and whether
    it does depends on the emitted fusion's loop structure — so the same
    formula can round differently between program variants (measured: the
    GSPMD-partitioned remap blend diverged from the unpartitioned one at
    ~3-per-million pixels). XORing the value's bits with a runtime zero the
    compiler cannot constant-fold forces the product to be materialized
    with its own rounding, making the plain two-rounding semantics hold on
    every backend and under every partitioning. optimization_barrier,
    f64 round-trips and double-bitcasts are all folded by LLVM; this
    survives (see ops/color_calibration.py, where the trick originated).

    rt_zero_i32: an int32 zero derived from runtime data, e.g.
    (x != x).astype(int32) for a known-non-NaN x. CAUTION (round-5
    lesson): the zero must be UNPROVABLE to the compiler. If x is
    integer-derived inside the same program (uitofp never yields NaN),
    LLVM folds (x != x) to false, the xor dissolves, and the seal
    silently stops working — the PCA solve shipped that way for four
    rounds. Derive the zero from a function argument (whose NaN-ness is
    unknowable, as color_calibration does) or from a value that CAN be
    non-finite at runtime, e.g. q - q with q = 1.0/some_runtime_value.
    """
    bits = jax.lax.bitcast_convert_type(v, jnp.int32) ^ rt_zero_i32
    return jax.lax.bitcast_convert_type(bits, jnp.float32)
