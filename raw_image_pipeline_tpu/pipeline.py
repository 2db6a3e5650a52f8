"""Functional ISP pipeline assembly.

The reference chains 8 modules in fixed order on one cv::Mat, materializing
a full frame between stages (raw_image_pipeline.hpp:143-172). Here the whole
chain is one pure function over a batch of frames, traced once per
(batch, height, width, encoding) and jitted so XLA fuses the pointwise
stages into a minimal number of device-memory passes:

    isp = build_pipeline(config)
    out, state = isp(params, batch, state)

Stage enables/methods are trace-time constants from PipelineConfig;
numeric parameters (matrices, LUTs, masks, undistortion maps, CCC model
FFTs) live in IspParams, a pytree argument — so recalibration never
recompiles.

Reference-behavior notes (SURVEY.md §8):
  * debayer ignores its `enabled` flag (debayer.hpp:38-40) — the per-call
    encoding decides, replicated here;
  * the reference CPU demosaic output is channel-swapped by a post-hoc
    RGB2BGR "fix" (debayer.cpp:49-52); we apply the same swap when
    algorithm == "bilinear" (the CPU-parity algorithm) and not for "mht"
    (the GPU-parity algorithm), matching each backend's observable output;
  * white balance is skipped for non-3-channel images
    (white_balance.hpp:50-52) — ours always runs post-debayer on BGR;
  * color-enhancer gains map straight onto (H, S, V); the reference's
    setter cross-wiring (color_enhancer.cpp:23-33) swaps hue/value gains on
    the ROS path and leaves them uninitialized on the YAML path — undefined
    behavior we do not replicate (all shipped configs use hue=value=1.0,
    where the difference vanishes);
  * undistortion runs only when a calibration is available and the model
    string is not "none" (undistortion.hpp:76-78); like the reference it
    always applies the fisheye model (SURVEY.md §8.8).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from raw_image_pipeline_tpu.config import PipelineConfig
from raw_image_pipeline_tpu.models.ccc_model import CCCModel, load_ccc_model
from raw_image_pipeline_tpu.ops import ccc as ccc_ops
from raw_image_pipeline_tpu.ops.color_calibration import (
    color_correct,
    color_correct_planes,
)
from raw_image_pipeline_tpu.ops.color_enhancer import (
    enhance_packed,
    enhance_planes,
    gain_corrections,
)
from raw_image_pipeline_tpu.ops.debayer import (
    BAYER_ENCODINGS,
    debayer,
    debayer_planes,
)
from raw_image_pipeline_tpu.ops.flip import flip as flip_op
from raw_image_pipeline_tpu.ops.lut import current_platform
from raw_image_pipeline_tpu.ops.resize import resize_linear_u8_plane
from raw_image_pipeline_tpu.ops.flip import flipped_bayer_encoding
from raw_image_pipeline_tpu.ops.gamma import (
    GAMMA_MAX_CORR,
    GAMMA_POLY_LEN,
    bt709_corrections,
    gamma_apply,
    gamma_apply_bt709,
    gamma_apply_poly,
    gamma_corrections,
    gamma_corrections_poly,
    gamma_poly_coeffs,
)
from raw_image_pipeline_tpu.ops.undistortion import (
    estimate_new_camera_matrix,
    init_undistort_rectify_map,
    remap_bilinear_u8,
    remap_bilinear_u8_planes,
    remap_precompute,
)
from raw_image_pipeline_tpu.ops.vignetting import (
    build_vignetting_mask,
    composed_gamma_corrections,
    composed_gamma_lab_fn,
)
from raw_image_pipeline_tpu.ops.vignetting import correct as vignetting_correct
from raw_image_pipeline_tpu.ops.vignetting import (
    correct_planes as vignetting_correct_planes,
)
from raw_image_pipeline_tpu.ops.white_balance import (
    balance_white_grey_world,
    balance_white_learned,
    balance_white_pca,
    balance_white_simple,
)

_UNSUPPORTED_BAYER = (
    "bayer_bggr16", "bayer_gbrg16", "bayer_grbg16", "bayer_rggb16",
)


@jax.tree_util.register_dataclass
@dataclass
class IspParams:
    """Numeric pipeline parameters (device pytree — changing values does not
    retrace)."""

    color_matrix: jax.Array  # [3,3] f32
    color_bias: jax.Array  # [3] f32
    gamma_k: jax.Array  # scalar f32 (pow fallback path)
    gamma_poly: jax.Array  # [GAMMA_POLY_LEN] f32 Horner coeffs (or zeros)
    gamma_corr_idx: jax.Array  # [GAMMA_MAX_CORR] i32 formula patch indices
    gamma_corr_val: jax.Array  # [GAMMA_MAX_CORR] u8 patch values
    # composed gamma∘(Lab sRGB-linearize) table corrections for the fused
    # gamma→vignetting fast path (ops/vignetting.composed_gamma_lab_fn);
    # idx all -1 when the composition is inactive
    vig_gamma_corr_idx: jax.Array  # [GAMMA_MAX_CORR] i32
    vig_gamma_corr_val: jax.Array  # [GAMMA_MAX_CORR] i32
    enhancer_gains: jax.Array  # [3] f32 (H,S,V)
    # cv::multiply f64-rounding corrections for the enhancer's f32 gain
    # multiply (ops/color_enhancer.gain_corrections); idx padded with -1
    enhancer_corr_idx: jax.Array  # [3, GAIN_CORR_SLOTS] i32
    enhancer_corr_val: jax.Array  # [3, GAIN_CORR_SLOTS] i32
    vignetting_mask: jax.Array  # [H,W] f32 (post-flip dims) or scalar 0 if unused
    # undistortion remap, precomputed from the fisheye maps at init
    # (ops/undistortion.remap_precompute); scalar 0 when unused. The
    # camera-blocked multicamera build stacks a leading camera axis here
    # ([C, Ho*Wo] / [C, 4, Ho*Wo]) — the only per-camera entries
    remap_base: jax.Array  # [Ho*Wo] i32 gather anchors
    remap_weights: jax.Array  # [4, Ho*Wo] f32 masked bilinear weights
    # CCC filter DFT (real/imag f32 [256,256]) + spatial bias (or scalar 0)
    ccc_filt_dft_re: jax.Array
    ccc_filt_dft_im: jax.Array
    ccc_bias: jax.Array
    # CCC tuning (the reference node's dynamic_reconfigure knobs): the
    # saturation-mask threshold tables ([256] f32 each, from the bright/dark
    # thresholds — ops/ccc.gray_mask_thresholds) + the log-chroma origin
    # uv0 — runtime params, so retuning never recompiles (scalar 0 when
    # CCC unused)
    ccc_gray_hi: jax.Array
    ccc_gray_lo: jax.Array
    ccc_uv0: jax.Array


# Cross-frame state: the CCC Kalman illuminant track.
IspState = ccc_ops.KalmanState


def init_state(batch_shape: Tuple[int, ...] = ()) -> IspState:
    """Fresh temporal-consistency state (equivalent to the reference's
    first_frame_=true after resetTemporalConsistency, ccc.cpp:433-435)."""
    return ccc_ops.kalman_init(batch_shape)


def save_state(state: IspState, path: str) -> None:
    """Checkpoint the cross-frame state (the CCC Kalman illuminant track)
    to an .npz. The reference holds this state only in process memory
    (cv::KalmanFilter member, ccc.cpp:300-340); persisting it lets a
    streaming job resume its illuminant track across restarts."""
    import numpy as np

    np.savez(
        path,
        x=np.asarray(state.x),
        p=np.asarray(state.p),
        initialized=np.asarray(state.initialized),
    )


def load_state(path: str) -> IspState:
    """Restore a checkpoint written by save_state."""
    import numpy as np

    d = np.load(path)
    return ccc_ops.KalmanState(
        x=jnp.asarray(d["x"]),
        p=jnp.asarray(d["p"]),
        initialized=jnp.asarray(d["initialized"]),
    )


@dataclass
class BuiltPipeline:
    """A pipeline traced for one static signature."""

    config: PipelineConfig
    params: IspParams
    ccc_model: Optional[CCCModel]
    fn: Any  # jitted (params, pixels, state) -> (outputs dict, state)

    def __call__(self, pixels, state=None):
        return self.fn(self.params, pixels, state)


def _post_flip_shape(h: int, w: int, angle: int) -> Tuple[int, int]:
    return (w, h) if angle in (90, 270) else (h, w)


@functools.lru_cache(maxsize=64)
def _composed_fit_cached(k: float, platform: str):
    fit = gamma_poly_coeffs(k)
    if fit is None:
        return None
    coeffs, root = fit
    try:
        return composed_gamma_corrections(k, coeffs, root, GAMMA_MAX_CORR)
    except ValueError:  # composed formula needs more corrections than the
        return None     # runtime-parameter pad — fall back to two stages


def _composed_gamma_fit(k: float):
    """Corrections pinning the composed gamma∘Lab-linearize table on the
    platform the pipeline is built for (ops/lut.current_platform), or None
    when the poly path / correction budget does not hold. Memoized per
    platform so make_params and make_isp_fn (which must agree on whether
    the composition engages) see the same answer."""
    return _composed_fit_cached(k, current_platform())


def make_params(
    config: PipelineConfig,
    frame_hw: Tuple[int, int],
    ccc_model: Optional[CCCModel] = None,
) -> IspParams:
    """Build the numeric parameter pytree for frames of shape frame_hw
    (pre-flip, i.e. sensor orientation)."""
    zero = jnp.zeros((), jnp.float32)

    h, w = frame_hw
    fh, fw = _post_flip_shape(h, w, config.flip.angle if config.flip.enabled else 0)

    if config.vignetting_correction.enabled:
        mask = jnp.asarray(
            build_vignetting_mask(
                fh, fw,
                config.vignetting_correction.scale,
                config.vignetting_correction.a2,
                config.vignetting_correction.a4,
            )
        )
    else:
        mask = zero

    calib = config.calibration
    run_undist = (
        config.undistortion.enabled
        and calib.calibration_available
        and calib.distortion_model != "none"
    )
    if run_undist:
        size = (calib.image_width, calib.image_height)
        new_size = config.undistortion.new_image_size or size
        new_K = estimate_new_camera_matrix(
            calib.K(), calib.D(), size, calib.R(),
            config.undistortion.balance, new_size, config.undistortion.fov_scale,
        )
        # maps stay at the calibration size like the reference
        # (undistortion.cpp:216-238 passes dist_image_size_)
        mx, my = init_undistort_rectify_map(calib.K(), calib.D(), calib.R(), new_K, size)
        # the remap source is the POST-FLIP frame: flip 90/270 swaps its
        # dims, and the calibration-sized maps then index it with
        # clamp+mask semantics exactly like cv::remap would
        base, weights = remap_precompute(
            mx, my, (fh, fw), mode=config.undistortion.interpolation
        )
        remap_base, remap_weights = jnp.asarray(base), jnp.asarray(weights)
    else:
        remap_base = remap_weights = zero

    wbc = config.white_balance
    if wbc.enabled and wbc.method == "ccc":
        if ccc_model is None:
            ccc_model = load_ccc_model(wbc.ccc_model_path)
        filt_re = jnp.asarray(ccc_model.filt_dft_re)
        filt_im = jnp.asarray(ccc_model.filt_dft_im)
        ccc_bias = jnp.asarray(ccc_model.bias)
        gray_hi, gray_lo = (jnp.asarray(t) for t in ccc_ops.gray_mask_thresholds(
            wbc.saturation_bright_thr, wbc.saturation_dark_thr
        ))
        uv0_rt = jnp.float32(wbc.ccc_uv0)
    else:
        filt_re = filt_im = ccc_bias = zero
        gray_hi = gray_lo = uv0_rt = zero

    gc = config.gamma_correction
    gamma_poly = np.zeros(GAMMA_POLY_LEN, np.float32)
    if gc.gpu and gc.method == "default":
        # reference GPU backend: fixed BT.709 curve, direction from k
        # (quirk §8.15; gamma_correction.cpp:29-33, 66-74)
        gamma_idx, gamma_val = bt709_corrections(gc.k <= 1.0)
    else:
        fit = gamma_poly_coeffs(gc.k)
        if fit is not None:  # poly-served LUT (the fast path; see ops/gamma)
            gamma_poly, root = fit
            gamma_idx, gamma_val = gamma_corrections_poly(gc.k, gamma_poly, root)
        else:
            gamma_idx, gamma_val = gamma_corrections(gc.k)

    # composed gamma∘vignetting table corrections (fast path only; the
    # traced fn decides usage — make_isp_fn consults the same memoized fit)
    comp_idx = np.full(GAMMA_MAX_CORR, -1, np.int32)
    comp_val = np.zeros(GAMMA_MAX_CORR, np.int32)
    if (
        gc.enabled and config.vignetting_correction.enabled
        and not (gc.gpu and gc.method == "default")
    ):
        comp = _composed_gamma_fit(gc.k)
        if comp is not None:
            comp_idx, comp_val = (
                np.asarray(comp[0], np.int32), np.asarray(comp[1], np.int32)
            )

    ce = config.color_enhancer
    ce_idx, ce_val = gain_corrections(
        [ce.hue_gain, ce.saturation_gain, ce.value_gain]
    )
    return IspParams(
        color_matrix=jnp.asarray(config.color_calibration.matrix_np(), jnp.float32).reshape(3, 3),
        color_bias=jnp.asarray(config.color_calibration.bias_np(), jnp.float32),
        gamma_k=jnp.float32(config.gamma_correction.k),
        gamma_poly=jnp.asarray(gamma_poly),
        gamma_corr_idx=jnp.asarray(gamma_idx),
        gamma_corr_val=jnp.asarray(gamma_val),
        vig_gamma_corr_idx=jnp.asarray(comp_idx),
        vig_gamma_corr_val=jnp.asarray(comp_val),
        enhancer_gains=jnp.asarray(
            [ce.hue_gain, ce.saturation_gain, ce.value_gain], jnp.float32
        ),
        enhancer_corr_idx=jnp.asarray(ce_idx),
        enhancer_corr_val=jnp.asarray(ce_val),
        vignetting_mask=mask,
        remap_base=remap_base,
        remap_weights=remap_weights,
        ccc_filt_dft_re=filt_re,
        ccc_filt_dft_im=filt_im,
        ccc_bias=ccc_bias,
        ccc_gray_hi=gray_hi,
        ccc_gray_lo=gray_lo,
        ccc_uv0=uv0_rt,
    )


def make_isp_fn(
    config: PipelineConfig,
    encoding: str,
    with_state: bool,
    keep_intermediates: bool = True,
    debug: bool = False,
    temporal_mode: str = "cameras",
    remap_src_hw: Optional[Tuple[int, int]] = None,
    planar_internals: bool = True,
    remap_tuning: Optional[Tuple[int, int]] = None,
    n_cameras: int = 1,
):
    """Trace-time assembly of the chain for a fixed encoding.

    Returns fn(params, pixels, state) -> (outputs, new_state) where outputs
    is a dict with "processed" and (if keep_intermediates) the reference's
    snapshots: "debayered" (post-flip, = getDistDebayeredImage via the flip
    module, raw_image_pipeline.cpp:225-227) and "dist_color" (pre-undistort,
    = getDistColorImage, undistortion.hpp:66-71).

    With debug=True, every stage output is additionally returned under
    "debug/0N_<stage>" keys mirroring the reference's saveDebugImage dump
    points (raw_image_pipeline.hpp:144-172). Each stage is wrapped in a
    jax.named_scope so traces from jax.profiler attribute time per ISP
    stage.

    planar_internals=False keeps the packed [..., 3] layout through the
    whole chain (bit-identical; see the planar comments below).

    n_cameras > 1 is the camera-blocked multicamera form (see
    parallel/multicamera.py): pixels arrive as [n_cameras, B, H, W], are
    flattened to one [n_cameras*B] batch for every shared-parameter stage
    (full-batch efficiency, no vmap — a vmapped gather is catastrophically
    slow, see ops/undistortion.DEFAULT_REMAP_TUNING), and only the remap
    consumes per-camera parameters: params.remap_base/remap_weights carry
    a leading camera axis and the camera-blocked gather routes each block
    through its own map. Outputs and state are returned with the [C, B]
    leading axes restored.
    """
    deb = config.debayer
    wb = config.white_balance
    use_ccc = wb.enabled and wb.method == "ccc"
    use_kalman = use_ccc and wb.temporal_consistency and with_state

    if encoding in _UNSUPPORTED_BAYER and deb.bayer16 == "error":
        # reference behavior (debayer.cpp:76-78); set DebayerConfig.bayer16
        # to "scale8" for the 16-bit extension
        raise ValueError(
            f"Encoding [{encoding}] is a valid pattern but is not supported!"
        )

    calib = config.calibration
    run_undist = (
        config.undistortion.enabled
        and calib.calibration_available
        and calib.distortion_model != "none"
    )
    # static gamma plan: poly-served LUT when a fit exists (same host fit
    # make_params runs; deterministic, so fn and params always agree)
    gcfg = config.gamma_correction
    gamma_poly_fit = (
        gamma_poly_coeffs(gcfg.k)
        if gcfg.enabled and not (gcfg.gpu and gcfg.method == "default")
        else None
    )
    # fold the gamma stage's u8 map into the vignetting forward's Lab
    # linearize table on the fast path (one composed table lookup, one
    # correction chain — ops/vignetting composition block). Static
    # decision; make_params builds the matching corrections from the same
    # memoized fit. Debug mode keeps the reference's two-stage order for
    # its dump points.
    compose_gv = (
        gamma_poly_fit is not None
        and config.vignetting_correction.enabled
        and not debug
        and _composed_gamma_fit(gcfg.k) is not None
    )

    def fn(params: IspParams, pixels: jax.Array, state: Optional[IspState]):
        outputs: Dict[str, jax.Array] = {}
        img = pixels

        cam_b = 0
        if n_cameras > 1:
            # camera-blocked execution: flatten [C, B, ...] -> [C*B, ...]
            # (camera-major) so every shared-parameter stage runs at full
            # batch; restored on exit. Temporal state: "cameras" mode
            # carries [C, B] independent tracks (flattened alongside);
            # "sequence" mode carries one track per camera ([C]-shaped
            # fields, batch axis = time within each camera block).
            cam_b = img.shape[1]
            img = img.reshape((-1,) + img.shape[2:])
            if state is not None and temporal_mode != "sequence":
                state = jax.tree.map(
                    lambda x: x.reshape((-1,) + x.shape[2:]), state
                )

        def dump(name, value):
            # reference stage dump points: /tmp/0N_<name>.png
            # (raw_image_pipeline.hpp:144-172)
            if debug:
                outputs["debug/" + name] = value

        # mono frames may arrive as [..., H, W] or [..., H, W, 1]; process
        # as channel-less and restore the trailing axis at the end
        mono_channel_axis = (
            encoding not in BAYER_ENCODINGS
            and encoding not in _UNSUPPORTED_BAYER
            and img.ndim >= 3
            and img.shape[-1] == 1
        )
        if mono_channel_axis:
            img = img[..., 0]

        # the CPU-parity demosaic algorithms carry the reference CPU path's
        # R<->B swap quirk (debayer.cpp:49-52); only "mht" (GPU parity) does not
        cpu_swap = deb.algorithm != "mht"

        # flip the 1-channel raw mosaic instead of the 3-channel color image
        # (3x less data) wherever the
        # rotated pattern has an exact demosaic equivalent — a bit-exact
        # identity on even-sized frames (flip.flipped_bayer_encoding). Debug
        # mode keeps the reference's stage order so the 00_debayer dump
        # matches the reference's pre-flip dump point.
        flip_angle = config.flip.angle if config.flip.enabled else 0
        hoist_enc = (
            flipped_bayer_encoding(encoding, flip_angle)
            if (not debug and encoding in BAYER_ENCODINGS)
            else None
        )
        hoist_flip = (
            hoist_enc is not None
            and img.shape[-1] % 2 == 0
            and img.shape[-2] % 2 == 0
        )

        # 1. debayer — always runs; per-call encoding decides (quirk §8.1).
        # When the planar fast path will engage right after (WB is CCC or
        # disabled), demosaic STRAIGHT to channel planes
        # (debayer.debayer_planes), which XLA fuses into each plane's
        # consumers.
        planes = None
        planar_from_debayer = (
            planar_internals and not debug
            and img.ndim == 3
            and (not wb.enabled or wb.method == "ccc")
        )
        with jax.named_scope("isp_debayer"):
            if hoist_flip or encoding in BAYER_ENCODINGS:
                if hoist_flip:
                    with jax.named_scope("isp_flip"):
                        img = flip_op(img, flip_angle, spatial_axes=(-2, -1))
                enc = hoist_enc if hoist_flip else encoding
                if planar_from_debayer:
                    planes = debayer_planes(img, enc, deb.algorithm)
                    if cpu_swap:
                        planes = planes[::-1]
                else:
                    img = debayer(img, enc, deb.algorithm)
                    if cpu_swap:
                        img = img[..., ::-1]
            elif encoding in _UNSUPPORTED_BAYER:
                # 16-bit extension: demosaic at full depth, scale into the
                # 8-bit chain
                img = debayer(img, encoding)
                img = (img >> 8).astype(jnp.uint8)
                if cpu_swap:
                    img = img[..., ::-1]
            elif encoding == "rgb8":
                img = img[..., ::-1]
            # other encodings pass through untouched (debayer.cpp:75)
        dump("00_debayer", img)

        # mono frames (e.g. "mono8" passthrough): the reference skips WB for
        # non-3-channel images (white_balance.hpp:50-52); the other color
        # stages would crash its cv ops outright, so they are skipped too
        is_color = planes is not None or (img.ndim >= 3 and img.shape[-1] == 3)

        # Early PLANAR unpack (see the "Internal PLANAR representation"
        # comment below for the rationale): when white balance is CCC or
        # disabled, the planes can be carried from the debayer output on —
        # the flip, CCC resize/gains and every later pointwise stage are
        # plane-in/plane-out, so the packed [..., 3] image is never
        # materialized at all on the fast path. The histogram-stat WB
        # methods (simple/grey_world/learned/pca) keep the packed form
        # until after WB.
        planar_early = planes is not None or (
            planar_internals
            and not debug and is_color and img.ndim == 4
            and (not wb.enabled or wb.method == "ccc")
        )
        if planar_early and planes is None:
            planes = (img[..., 0], img[..., 1], img[..., 2])

        # 2. flip (already applied pre-debayer when hoist_flip)
        with jax.named_scope("isp_flip"):
            if config.flip.enabled and not hoist_flip:
                if planar_early:
                    planes = tuple(
                        flip_op(p, config.flip.angle, spatial_axes=(-2, -1))
                        for p in planes
                    )
                else:
                    img = flip_op(
                        img, config.flip.angle,
                        spatial_axes=(-3, -2) if is_color else (-2, -1),
                    )
        if keep_intermediates:
            # flip-module snapshot (flip.cpp:59-61)
            outputs["debayered"] = (
                jnp.stack(planes, axis=-1) if planar_early else img
            )
        dump("01_flip", img)

        # 3. white balance
        with jax.named_scope("isp_white_balance"):
            if wb.enabled and is_color:
                if use_ccc:
                    if planar_early:
                        # plane-form resize: wide lane dims + vertical-tap
                        # row preselection (ops/resize.resize_linear_u8_plane
                        # — bit-exact vs the packed form)
                        small = jnp.stack(
                            [
                                resize_linear_u8_plane(
                                    p, ccc_ops.SMALL_H, ccc_ops.SMALL_W
                                )
                                for p in planes
                            ],
                            axis=-1,
                        )
                    else:
                        small = ccc_ops.resize_linear_u8(
                            img, ccc_ops.SMALL_H, ccc_ops.SMALL_W
                        )
                    hist = ccc_ops.log_chroma_histogram_rt(
                        small, params.ccc_gray_hi, params.ccc_gray_lo,
                        params.ccc_uv0,
                    )
                    resp = ccc_ops.ccc_response(
                        hist, params.ccc_filt_dft_re, params.ccc_filt_dft_im,
                        params.ccc_bias,
                    )
                    uv = ccc_ops.response_argmax(resp)
                    if use_kalman:
                        if temporal_mode == "sequence":
                            if n_cameras > 1:
                                # per-camera tracks advance through their
                                # own block's time axis: scan over time
                                # with cameras as the trailing batch
                                uvc = uv.reshape(n_cameras, cam_b, -1)
                                uvc = jnp.swapaxes(uvc, 0, 1)  # [T, C, 2]
                                state, uvc = ccc_ops.kalman_scan(state, uvc)
                                uv = jnp.swapaxes(uvc, 0, 1).reshape(
                                    n_cameras * cam_b, -1
                                )
                            else:
                                # batch axis = time: one shared track
                                # advanced through all frames
                                state, uv = ccc_ops.kalman_scan(state, uv)
                        else:
                            # batch axis = independent cameras, one track each
                            state, uv = ccc_ops.kalman_update(state, uv)
                    gains = ccc_ops.gains_from_uv(uv, params.ccc_uv0)
                    if planar_early:
                        planes = ccc_ops.apply_gains_planes(planes, gains)
                    else:
                        img = ccc_ops.apply_gains(img, gains)
                elif wb.method == "simple":
                    img = balance_white_simple(img, wb.clipping_percentile)
                elif wb.method in ("grey_world", "gray_world"):
                    img = balance_white_grey_world(img, wb.saturation_bright_thr)
                elif wb.method == "learned":
                    img = balance_white_learned(img, wb.saturation_bright_thr)
                elif wb.method == "pca":
                    img = balance_white_pca(img)
                else:
                    raise ValueError(
                        f"White Balance method [{wb.method}] not supported"
                    )
        dump("02_white_balancing", img)

        # Internal batch-minor layout [H, W, B, C] for the remainder of the
        # chain whenever the remap will run: the pointwise stages are
        # layout-invariant in cost (measured), but remap flattens to
        # [H*W, B*C] — spatial-major means that flatten is free instead of
        # two 0.4 GB/batch layout moves around the gather. Not engaged in
        # debug mode (the reference's dump layout is kept 1:1 there).
        batch_minor = (
            run_undist and not debug
            and (planes is not None or (is_color and img.ndim == 4))
        )
        if batch_minor:
            if planar_early:
                planes = tuple(jnp.transpose(p, (1, 2, 0)) for p in planes)
            else:
                img = jnp.transpose(img, (1, 2, 0, 3))

        # Internal PLANAR representation (three separate u8 channel planes)
        # for the pointwise stretch: every colorspace/matrix stage slices
        # the channel-minor u8 axis on entry and re-stacks on exit, and
        # those passes can cost more than the math itself (they did on the
        # accelerator this chain was first tuned for; not measured on the
        # H100). Carrying planes end-to-end pays the unpack once and
        # lets XLA fuse plane-in/plane-out stages with zero channel
        # shuffling. Bit-identical: the packed ops are thin slice/stack
        # wrappers around the same planar cores. Debug mode keeps the
        # packed reference layout for its dump points.
        planar = planes is not None or (
            planar_internals and is_color and img.ndim == 4 and not debug
        )
        if planar and planes is None:
            planes = (img[..., 0], img[..., 1], img[..., 2])

        # 4. color calibration (3-channel only, like WB — the reference's
        # cv ops would fail outright on mono)
        with jax.named_scope("isp_color_calibration"):
            if config.color_calibration.enabled and is_color:
                if planar:
                    planes = color_correct_planes(
                        *planes, params.color_matrix, params.color_bias
                    )
                else:
                    img = color_correct(img, params.color_matrix, params.color_bias)
        dump("03_color_calibration", img)

        # 5. gamma (folded into the vignetting forward table when
        # compose_gv and the planar fast path are both active)
        with jax.named_scope("isp_gamma"):
            gc = config.gamma_correction
            if gc.enabled and not (compose_gv and planar and is_color):
                if gc.gpu and gc.method == "default":
                    apply_g = lambda x: gamma_apply_bt709(
                        x, gc.k <= 1.0,
                        params.gamma_corr_idx, params.gamma_corr_val,
                    )
                elif gamma_poly_fit is not None:
                    apply_g = lambda x: gamma_apply_poly(
                        x, params.gamma_poly,
                        params.gamma_corr_idx, params.gamma_corr_val,
                        root=gamma_poly_fit[1],
                    )
                else:
                    apply_g = lambda x: gamma_apply(
                        x, params.gamma_k,
                        params.gamma_corr_idx, params.gamma_corr_val,
                    )
                if planar:
                    planes = tuple(apply_g(p) for p in planes)
                else:
                    img = apply_g(img)
        dump("04_gamma_correction", img)

        # 6. vignetting (Lab roundtrip — 3-channel only; consumes the
        # composed gamma∘linearize table when the gamma stage was folded)
        with jax.named_scope("isp_vignetting"):
            if config.vignetting_correction.enabled and is_color:
                mask = params.vignetting_mask
                if batch_minor:
                    mask = mask[:, :, None]  # broadcast [H,W,1] over [H,W,B]
                if planar:
                    gamma_fn = None
                    if compose_gv:
                        gamma_fn = composed_gamma_lab_fn(
                            params.gamma_poly,
                            params.vig_gamma_corr_idx,
                            params.vig_gamma_corr_val,
                            root=gamma_poly_fit[1],
                        )
                    planes = vignetting_correct_planes(
                        *planes, mask, gamma_fn=gamma_fn
                    )
                else:
                    img = vignetting_correct(img, mask)
        dump("05_vignetting_correction", img)

        # 7. color enhancer (HSV roundtrip — 3-channel only). The frame's
        # W axis position (cv2 mixes its SIMD/scalar row kernels by
        # column; ops/color_enhancer) depends on the internal layout.
        with jax.named_scope("isp_color_enhancer"):
            if config.color_enhancer.enabled and is_color:
                ce_corr = (params.enhancer_corr_idx, params.enhancer_corr_val)
                if planar:
                    planes = enhance_planes(
                        *planes, params.enhancer_gains,
                        w_axis=1 if batch_minor else -1, corr=ce_corr,
                    )
                else:
                    img = enhance_packed(
                        img, params.enhancer_gains,
                        w_axis=1 if batch_minor else -2, corr=ce_corr,
                    )
        dump("06_color_enhancer", img)

        # 8. undistortion — the pre-undistort snapshot is taken whether or
        # not the remap runs (undistortion.hpp:66-78)
        if keep_intermediates:
            if planar:
                packed = jnp.stack(planes, axis=-1)
                outputs["dist_color"] = (
                    jnp.transpose(packed, (2, 0, 1, 3)) if batch_minor
                    else packed
                )
            else:
                outputs["dist_color"] = (
                    jnp.transpose(img, (2, 0, 1, 3)) if batch_minor else img
                )
        with jax.named_scope("isp_undistortion"):
            if run_undist:
                out_hw = (calib.image_height, calib.image_width)
                rt = {} if remap_tuning is None else {"tuning": remap_tuning}
                rt["mode"] = config.undistortion.interpolation
                # per-camera maps (camera-blocked build): stacked base
                # [n_cameras, N] routes each camera block through its own
                # map in one flat gather; a flat base (shared calibration)
                # just treats the whole [C*B] batch as one
                cams = n_cameras if (
                    n_cameras > 1 and params.remap_base.ndim == 2
                ) else 1
                if cams > 1:
                    rt["n_cameras"] = cams
                if planar and batch_minor:
                    out = remap_bilinear_u8_planes(
                        planes, params.remap_base, params.remap_weights,
                        out_hw, remap_src_hw, **rt,
                    )  # [Ho, Wo, C, B] or [cams, Ho, Wo, C, B']
                    if cams > 1:
                        img = jnp.transpose(out, (0, 4, 1, 2, 3)).reshape(
                            (-1,) + out.shape[1:3] + (out.shape[3],)
                        )
                    else:
                        img = jnp.transpose(out, (3, 0, 1, 2))
                    planar = False
                elif batch_minor:
                    img = remap_bilinear_u8(
                        img, params.remap_base, params.remap_weights, out_hw,
                        remap_src_hw, batch_minor=True, **rt,
                    )
                    if cams > 1:  # [cams, Ho, Wo, B', C]
                        img = jnp.transpose(img, (0, 3, 1, 2, 4)).reshape(
                            (-1,) + img.shape[1:3] + (img.shape[4],)
                        )
                    else:
                        img = jnp.transpose(img, (2, 0, 1, 3))
                elif is_color:
                    img = remap_bilinear_u8(
                        img, params.remap_base, params.remap_weights, out_hw,
                        remap_src_hw, **rt,
                    )
                else:
                    # remap expects a channel axis; run mono as [..., H, W, 1]
                    img = remap_bilinear_u8(
                        img[..., None], params.remap_base, params.remap_weights,
                        out_hw, remap_src_hw, **rt,
                    )[..., 0]
        if planar:
            # no remap consumed the planes — repack for the output contract
            img = jnp.stack(planes, axis=-1)
            if batch_minor:
                img = jnp.transpose(img, (2, 0, 1, 3))
        dump("07_undistortion", img)

        if mono_channel_axis:
            img = img[..., None]
        outputs["processed"] = img
        if n_cameras > 1:
            # restore the [C, B] leading axes on every output and the
            # flattened "cameras"-mode state
            outputs = {
                kk: v.reshape((n_cameras, cam_b) + v.shape[1:])
                for kk, v in outputs.items()
            }
            if state is not None and temporal_mode != "sequence":
                state = jax.tree.map(
                    lambda x: x.reshape((n_cameras, cam_b) + x.shape[1:]),
                    state,
                )
        return outputs, state

    return fn


def _chunked_fn(inner_fn, microbatch: int, with_state: bool):
    """Wrap an isp fn to process the batch as sequential `microbatch`-sized
    chunks inside one dispatch (see build_pipeline's microbatch doc)."""

    def fn(p, pixels, state):
        b = pixels.shape[0]
        if b <= microbatch:
            return inner_fn(p, pixels, state)
        # a batch that is not a multiple of `microbatch` runs the full
        # chunks through the scan/map and the remainder through one extra
        # (smaller) traced instance of the chain, state carried through in
        # order — so stateful tail batches (StreamRunner with temporal
        # consistency) work instead of raising
        rem = b % microbatch
        full = b - rem
        xs = pixels[:full].reshape((full // microbatch, microbatch) + pixels.shape[1:])
        if with_state:
            def body(st, chunk):
                out, st2 = inner_fn(p, chunk, st)
                return st2, out
            state, outs = jax.lax.scan(body, state, xs)
        else:
            outs = jax.lax.map(lambda c: inner_fn(p, c, None)[0], xs)
        outputs = {k: v.reshape((full,) + v.shape[2:]) for k, v in outs.items()}
        if rem:
            tail, state = inner_fn(p, pixels[full:], state)
            outputs = {
                k: jnp.concatenate([outputs[k], tail[k]]) for k in outputs
            }
        return outputs, state

    return fn


def build_pipeline(
    config: PipelineConfig,
    encoding: str = "bayer_gbrg8",
    frame_hw: Optional[Tuple[int, int]] = None,
    with_state: bool = False,
    keep_intermediates: bool = False,
    ccc_model: Optional[CCCModel] = None,
    donate: bool = False,
    debug: bool = False,
    temporal_mode: str = "cameras",
    microbatch: Optional[int] = None,
) -> BuiltPipeline:
    """Build and jit the full ISP for one configuration.

    frame_hw defaults to the calibration's image size. The returned object
    is callable: outputs, state = pipe(pixels, state). Input pixels:
    [B, H, W] uint8 for Bayer encodings, [B, H, W, 3] for color.

    The same program runs unchanged under any jax.sharding.Mesh: GSPMD
    shards the batch (and, for a "space" axis, the rows — halo exchanges
    for the stencils, psums for the CCC histogram) without changing a
    single output bit (tests/test_parallel.py).

    temporal_mode (only relevant with CCC temporal consistency + state):
      * "cameras" — batch entries are independent streams, state is batched
        like the pixels (one Kalman track per entry);
      * "sequence" — batch entries are consecutive frames of one stream,
        state is a single track advanced through them in order
        (bitwise equal to feeding the frames one dispatch at a time).

    microbatch: process the batch as sequential chunks of this size inside
    one dispatch (lax.map, or lax.scan when state is carried) — bounds peak
    device memory at roughly the chunk working set, letting batches run
    that exceed single-dispatch memory. Bitwise identical to the unchunked program, incl. the temporal
    track. A batch that is not a multiple of `microbatch` runs its
    remainder as one extra smaller chunk (state carried through in order).
    """
    if frame_hw is None:
        frame_hw = (config.calibration.image_height, config.calibration.image_width)
    if (
        config.white_balance.enabled
        and config.white_balance.method == "ccc"
        and ccc_model is None
    ):
        ccc_model = load_ccc_model(config.white_balance.ccc_model_path)
    params = make_params(config, frame_hw, ccc_model)
    # the remap's base/weights are precomputed against the post-flip dims of
    # frame_hw; the traced fn checks actual frames against this at trace time
    src_hw = _post_flip_shape(
        *frame_hw, config.flip.angle if config.flip.enabled else 0
    )
    raw_fn = make_isp_fn(
        config, encoding, with_state, keep_intermediates, debug, temporal_mode,
        remap_src_hw=src_hw,
    )
    if microbatch:
        raw_fn = _chunked_fn(raw_fn, microbatch, with_state)

    jitted = jax.jit(raw_fn, donate_argnums=(1,) if donate else ())
    return BuiltPipeline(
        config=config, params=params, ccc_model=ccc_model, fn=jitted,
    )
