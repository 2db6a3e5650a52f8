"""Multi-camera execution (BASELINE config 5: 4 cameras, N>=2 hosts).

The reference runs one ROS node per camera; here all cameras execute in one
jitted program. The formulation is CAMERA-BLOCKED, not vmapped:
the [n_cameras, B] leading axes flatten into one camera-major batch so
every shared-parameter stage (debayer, flip, CCC statistics, gamma,
vignetting, HSV) runs at full n_cameras*B batch efficiency, and the only
per-camera-parameter stage — the undistortion remap — routes each camera
block through its own precomputed map via a single flat chunked gather
over a row-concatenated tap pack (ops/undistortion._remap_rows).

Why not jax.vmap: a vmapped gather lost the fast chunked row-gather rate
and acquired a large batch-independent cost on the accelerator this was
first built for (not re-measured on the H100). The camera-blocked form
has no batched gathers anywhere.

When every camera shares one calibration, the stacked maps collapse to a
single shared map and the remap spends one index per output PIXEL for all
cameras (indices amortize over the whole n_cameras*B batch); with
distinct calibrations it spends one index per pixel per camera — the
intrinsic minimum either way.

The camera axis then shards over the mesh's "data" axis like any other
batch dimension — cameras x frames spread across chips/hosts with no
cross-camera collectives — and each camera carries its own Kalman
illuminant track.

Constraint: cameras share the static configuration (stage enables, WB
method, frame size) — that is what keeps one trace; per-camera *values*
(intrinsics, distortion) differ freely.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from raw_image_pipeline_tpu.config import CameraCalibration, PipelineConfig
from raw_image_pipeline_tpu.ops import ccc as ccc_ops
from raw_image_pipeline_tpu.pipeline import (
    BuiltPipeline,
    IspState,
    make_isp_fn,
    make_params,
)
from raw_image_pipeline_tpu.models.ccc_model import load_ccc_model


def multicamera_state(
    n_cameras: int, batch: int = 1, temporal_mode: str = "cameras"
) -> IspState:
    """Per-camera Kalman state: [n_cameras, batch, ...] tracks in "cameras"
    mode (every batch slot an independent stream), [n_cameras, ...] in
    "sequence" mode (one track per camera, batch axis = time)."""
    if temporal_mode == "sequence":
        return ccc_ops.kalman_init((n_cameras,))
    return ccc_ops.kalman_init((n_cameras, batch))


def build_multicamera_pipeline(
    base_config: PipelineConfig,
    calibrations: Sequence[CameraCalibration],
    encoding: str = "bayer_gbrg8",
    frame_hw: Optional[Tuple[int, int]] = None,
    with_state: bool = False,
    temporal_mode: str = "cameras",
) -> BuiltPipeline:
    """One jitted camera-blocked program over [n_cameras, batch, H, W].

    Returns a BuiltPipeline whose params carry a leading camera axis on
    the per-camera entries (the remap maps); call as
    outputs, state = pipe(frames, state) with frames [C, B, H, W]."""
    n = len(calibrations)
    if n == 0:
        raise ValueError("need at least one camera calibration")
    if frame_hw is None:
        frame_hw = (calibrations[0].image_height, calibrations[0].image_width)
    for c in calibrations:
        # calibrations may differ in values but must share the frame size
        if (c.image_height, c.image_width) != frame_hw:
            raise ValueError("all cameras must share one frame size")

    ccc_model = None
    wb = base_config.white_balance
    if wb.enabled and wb.method == "ccc":
        ccc_model = load_ccc_model(wb.ccc_model_path)

    # the per-camera configs differ only in `calibration`, and make_params
    # derives only remap_base/remap_weights from it — every other param is
    # identical by construction. Decide map sharing on the HOST dataclasses
    # (no device readback needed).
    maps_shared = all(c == calibrations[0] for c in calibrations[1:])
    p0 = make_params(
        base_config.replace(calibration=calibrations[0]), frame_hw, ccc_model
    )
    if maps_shared:
        # one gather index per output pixel for ALL cameras
        params = p0
    else:
        per_cam = [p0] + [
            make_params(base_config.replace(calibration=c), frame_hw, ccc_model)
            for c in calibrations[1:]
        ]
        params = dataclasses.replace(
            p0,
            remap_base=jnp.stack([p.remap_base for p in per_cam]),
            remap_weights=jnp.stack([p.remap_weights for p in per_cam]),
        )

    from raw_image_pipeline_tpu.pipeline import _post_flip_shape

    src_hw = _post_flip_shape(
        *frame_hw, base_config.flip.angle if base_config.flip.enabled else 0
    )
    single_fn = make_isp_fn(
        base_config.replace(calibration=calibrations[0]),
        encoding, with_state, keep_intermediates=False,
        remap_src_hw=src_hw, temporal_mode=temporal_mode, n_cameras=n,
    )
    if with_state:
        jitted = jax.jit(single_fn)
    else:
        jitted = jax.jit(lambda p, px, state: (single_fn(p, px, None)[0], state))

    return BuiltPipeline(
        config=base_config, params=params, ccc_model=ccc_model, fn=jitted,
    )
