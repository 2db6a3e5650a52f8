"""3x3 affine color calibration (reference: modules/color_calibration.cpp:91-104).

The reference flattens the frame to (H*W)x3 float, right-multiplies by the
transposed 3x3 BGR mixing matrix, adds a per-channel bias, and saturates to
uint8. Here it is 9 sealed multiplies and adds per pixel that XLA fuses
with the neighboring stages (the (HW)x3 @ 3x3 matmul is too skinny for a
matrix unit to matter).

Rounding: cv::Mat::convertTo(CV_8UC3) == cvRound (half-to-even) + saturate.
The reference computes in float32 (color_calibration.cpp:93-94); we do the
same.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raw_image_pipeline_tpu.ops.common import round_u8, seal_f32


def color_correct_planes(b: jax.Array, g: jax.Array, r: jax.Array,
                         matrix: jax.Array, bias: jax.Array):
    """Planar core: three u8 planes -> three u8 planes.

    cv::gemm's K=3 kernel is the PLAIN left-associative chain
    rn(rn(rn(b*m0) + rn(g*m1)) + rn(r*m2)) — verified against cv2.gemm
    over 20 random matrices x 100k pixels with zero f32 mismatches.
    (numpy's BLAS sgemm is an fma chain instead and differs from cv2 at
    ~22% of f32 values / ~1% of final u8 pixels — the old einsum matched
    that proxy, not the reference.)

    Codegen hazard: XLA:CPU's LLVM backend contracts mul+add into fma
    even across optimization_barrier / f64-step / double-bitcast
    formulations (all measured folded), and XLA:GPU's may. Each product is
    therefore "sealed" by an integer XOR with a runtime zero the compiler
    cannot constant-fold (ops/common.seal_f32), pinning the plain
    two-rounding semantics on every backend for ~3 cheap int ops per
    product (verified over all 2^24 u8 triples on XLA:CPU and on an H100
    by chip_smoke.py).
    """
    f32 = jnp.float32
    m = matrix.astype(f32)
    rt_zero = (m[0, 0] != m[0, 0]).astype(jnp.int32)  # 0 unless NaN config

    def seal(v):
        return seal_f32(v, rt_zero)

    bf = b.astype(f32)
    gf = g.astype(f32)
    rf = r.astype(f32)
    return tuple(
        round_u8(
            (seal(bf * m[o, 0]) + seal(gf * m[o, 1])) + seal(rf * m[o, 2])
            + bias[o].astype(f32)
        )
        for o in range(3)
    )


@jax.jit
def color_correct(image: jax.Array, matrix: jax.Array, bias: jax.Array) -> jax.Array:
    """Args:
        image:  [..., 3] uint8 BGR.
        matrix: [3, 3] float32 — rows produce output B,G,R from input (B,G,R).
        bias:   [3] float32 BGR bias.

    Packed wrapper around color_correct_planes (same arithmetic; use the
    planar form in performance paths, which skips the channel-minor
    slice/stack passes)."""
    out = color_correct_planes(
        image[..., 0], image[..., 1], image[..., 2], matrix, bias
    )
    return jnp.stack(out, axis=-1)
