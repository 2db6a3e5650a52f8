"""Reference-compatible Python API.

`RawImagePipeline` mirrors the reference pybind11 surface method-for-method
(reference: raw_image_pipeline_python/src/raw_image_pipeline_python.cpp:14-73
binding raw_image_pipeline.hpp:36-137), with numpy in/out. Single frames
([H,W] Bayer or [H,W,3] BGR) are processed like the reference; batched
frames ([B,H,W]/[B,H,W,3]) are an extension and behave exactly like a
frame-by-frame loop.

Jitted pipelines are cached per (shape, encoding); setters invalidate the
cache, so reconfiguring behaves like the reference's stateful setters
without recompiling on every call. Changing only numeric values (e.g.
calibration matrices) rebuilds the parameter pytree, not the trace.

Note on batch shapes: each distinct batch size is its own trace (XLA wants
static shapes). Callers streaming with CCC temporal consistency should
feed a FIXED batch size (pad or buffer to it) — a drained-queue pattern
with varying sizes pays a full-chain compile per new size. StreamRunner
already batches to a fixed size for this reason.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, Optional, Tuple

import numpy as np

from raw_image_pipeline_tpu import config as cfg
from raw_image_pipeline_tpu.pipeline import (
    BuiltPipeline,
    build_pipeline,
    init_state,
)


class RawImagePipeline:
    """Drop-in equivalent of py_raw_image_pipeline.RawImagePipeline."""

    def __init__(
        self,
        use_gpu: bool = False,
        params_path: str = "",
        calibration_path: str = "",
        color_calibration_path: str = "",
    ):
        # use_gpu selects the reference's CUDA backend; here there is one
        # backend. We keep the flag to select the GPU-parity demosaic
        # algorithm (MHT) like the reference GPU path would.
        self._use_gpu = use_gpu
        self._debug = False
        self._state = None
        self._cache: Dict[Tuple, BuiltPipeline] = {}
        self._last_outputs: Dict[str, np.ndarray] = {}

        base = cfg.PipelineConfig()
        if use_gpu:
            base = base.replace(
                debayer=replace(base.debayer, algorithm="mht"),
                gamma_correction=replace(base.gamma_correction, gpu=True),
            )

        self._config = cfg.load_pipeline_params(
            params_path or cfg.DEFAULT_PARAMS_PATH, base
        )
        if calibration_path:
            self.load_camera_calibration(calibration_path)
        color_path = color_calibration_path or cfg.DEFAULT_COLOR_CALIBRATION_PATH
        self.load_color_calibration(color_path)

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _invalidate(self, **config_updates):
        if config_updates:
            self._config = self._config.replace(**config_updates)
        self._cache.clear()

    def _module(self, name):
        return getattr(self._config, name)

    def _set_module(self, name, **kw):
        self._invalidate(**{name: replace(self._module(name), **kw)})

    def _pipeline_for(self, shape, encoding) -> BuiltPipeline:
        wb = self._config.white_balance
        with_state = wb.enabled and wb.method == "ccc" and wb.temporal_consistency
        key = (shape, encoding, with_state, self._debug)
        pipe = self._cache.get(key)
        if pipe is None:
            frame_hw = shape[1], shape[2]
            pipe = build_pipeline(
                self._config,
                encoding,
                frame_hw=frame_hw,
                with_state=with_state,
                keep_intermediates=True,
                debug=self._debug,
                temporal_mode="sequence",
            )
            self._cache[key] = pipe
        return pipe

    def _run(self, image: np.ndarray, encoding: str):
        image = np.asarray(image)
        if image.size == 0:
            # empty-image early return like the node's callback guard
            # (raw_image_pipeline_ros.cpp:231-234)
            return image
        single = image.ndim == 2 or (image.ndim == 3 and image.shape[-1] in (1, 3))
        batch = image[None] if single else image
        wb = self._config.white_balance
        with_state = wb.enabled and wb.method == "ccc" and wb.temporal_consistency

        if with_state:
            # temporal consistency is one sequential illuminant track, like
            # the reference's single camera stream. The heavy stages batch
            # over the frames in one dispatch; only the 2-float Kalman
            # recurrence runs sequentially (temporal_mode="sequence" scans
            # it over the per-frame argmax measurements). Use
            # build_multicamera_pipeline for parallel per-camera tracks.
            if self._state is None:
                self._state = init_state(())
            pipe = self._pipeline_for(batch.shape, encoding)
            outputs, self._state = pipe(batch, self._state)
        else:
            pipe = self._pipeline_for(batch.shape, encoding)
            outputs, _ = pipe(batch, None)

        # keep device arrays; materialize lazily in the getters (the
        # intermediates are full frames most callers never read)
        self._last_outputs = {
            k: (v[0] if single else v) for k, v in outputs.items()
        }
        if self._debug:
            self._write_debug_dumps()
        return np.asarray(self._last_outputs["processed"])

    def _write_debug_dumps(self):
        """Write per-stage dumps like the reference's saveDebugImage:
        min-max normalized PNGs at /tmp/0N_<stage>.png
        (raw_image_pipeline.hpp:179-199)."""
        try:
            import cv2
        except ImportError:
            return
        for key, img in self._last_outputs.items():
            if not key.startswith("debug/"):
                continue
            img = np.asarray(img)
            frame = img[0] if img.ndim == 4 else img
            f = frame.astype(np.float64)
            lo, hi = f.min(), f.max()
            norm = (f - lo) * (255.0 / (hi - lo)) if hi > lo else f
            cv2.imwrite(f"/tmp/{key.split('/')[1]}.png", norm.astype(np.uint8))

    # ------------------------------------------------------------------
    # main interfaces (raw_image_pipeline.hpp:40-56)
    # ------------------------------------------------------------------

    def apply(self, image: np.ndarray, encoding: str) -> bool:
        """Process and, when the output shape matches the input buffer,
        write the result back in place (the binding shares the numpy buffer
        with C++, raw_image_pipeline_python.cpp:23)."""
        out = self._run(image, encoding)
        if out.shape == image.shape and image.flags.writeable:
            image[...] = out
        return True

    def process(self, image: np.ndarray, encoding: str) -> np.ndarray:
        return self._run(image, encoding).copy()

    def load_params(self, file_path: str) -> None:
        self._config = cfg.load_pipeline_params(file_path, self._config)
        self._cache.clear()

    def load_camera_calibration(self, file_path: str) -> None:
        self._invalidate(calibration=cfg.load_camera_calibration(file_path))

    def load_color_calibration(self, file_path: str) -> None:
        self._invalidate(
            color_calibration=cfg.load_color_calibration(
                file_path, self._config.color_calibration
            )
        )

    def init_undistortion(self) -> None:
        self._cache.clear()

    # ------------------------------------------------------------------
    # misc (raw_image_pipeline.hpp:58-64)
    # ------------------------------------------------------------------

    def set_gpu(self, use_gpu: bool) -> None:
        self._use_gpu = use_gpu
        algo = "mht" if use_gpu else "bilinear"
        self._set_module("debayer", algorithm=algo)
        # the GPU backend's "default" gamma is the fixed BT.709 NPP curve
        # (quirk §8.15)
        self._set_module("gamma_correction", gpu=use_gpu)

    def set_debug(self, debug: bool) -> None:
        self._debug = debug

    def reset_white_balance_temporal_consistency(self) -> None:
        self._state = None

    def _materialize(self, key) -> Optional[np.ndarray]:
        v = self._last_outputs.get(key)
        return None if v is None else np.asarray(v)

    def get_processed_image(self) -> Optional[np.ndarray]:
        return self._materialize("processed")

    def get_dist_debayered_image(self) -> Optional[np.ndarray]:
        return self._materialize("debayered")

    def get_dist_color_image(self) -> Optional[np.ndarray]:
        return self._materialize("dist_color")

    # ------------------------------------------------------------------
    # setters (raw_image_pipeline.hpp:66-104)
    # ------------------------------------------------------------------

    def set_debayer(self, enabled: bool) -> None:
        self._set_module("debayer", enabled=enabled)

    def set_debayer_encoding(self, encoding: str) -> None:
        self._set_module("debayer", encoding=encoding)

    def set_flip(self, enabled: bool) -> None:
        self._set_module("flip", enabled=enabled)

    def set_flip_angle(self, angle: int) -> None:
        self._set_module("flip", angle=angle)

    def set_white_balance(self, enabled: bool) -> None:
        self._set_module("white_balance", enabled=enabled)

    def set_white_balance_method(self, method: str) -> None:
        self._set_module("white_balance", method=method)

    def set_white_balance_percentile(self, percentile: float) -> None:
        self._set_module("white_balance", clipping_percentile=percentile)

    def set_white_balance_saturation_threshold(self, bright_thr: float, dark_thr: float) -> None:
        self._set_module(
            "white_balance",
            saturation_bright_thr=bright_thr,
            saturation_dark_thr=dark_thr,
        )

    def set_white_balance_temporal_consistency(self, enabled: bool) -> None:
        self._set_module("white_balance", temporal_consistency=enabled)

    def set_color_calibration(self, enabled: bool) -> None:
        self._set_module("color_calibration", enabled=enabled)

    def set_color_calibration_matrix(self, matrix) -> None:
        self._set_module("color_calibration", matrix=tuple(np.asarray(matrix, float).ravel()))

    def set_color_calibration_bias(self, bias) -> None:
        self._set_module("color_calibration", bias=tuple(np.asarray(bias, float).ravel()))

    def get_color_calibration_matrix(self) -> np.ndarray:
        return self._config.color_calibration.matrix_np()

    def get_color_calibration_bias(self) -> np.ndarray:
        return self._config.color_calibration.bias_np().reshape(3, 1)

    def set_gamma_correction(self, enabled: bool) -> None:
        self._set_module("gamma_correction", enabled=enabled)

    def set_gamma_correction_method(self, method: str) -> None:
        self._set_module("gamma_correction", method=method)

    def set_gamma_correction_k(self, k: float) -> None:
        self._set_module("gamma_correction", k=k)

    def set_vignetting_correction(self, enabled: bool) -> None:
        self._set_module("vignetting_correction", enabled=enabled)

    def set_vignetting_correction_parameters(self, scale: float, a2: float, a4: float) -> None:
        self._set_module("vignetting_correction", scale=scale, a2=a2, a4=a4)

    def set_color_enhancer(self, enabled: bool) -> None:
        self._set_module("color_enhancer", enabled=enabled)

    def set_color_enhancer_hue_gain(self, gain: float) -> None:
        self._set_module("color_enhancer", hue_gain=gain)

    def set_color_enhancer_saturation_gain(self, gain: float) -> None:
        self._set_module("color_enhancer", saturation_gain=gain)

    def set_color_enhancer_value_gain(self, gain: float) -> None:
        self._set_module("color_enhancer", value_gain=gain)

    def set_undistortion(self, enabled: bool) -> None:
        self._set_module("undistortion", enabled=enabled)

    def set_undistortion_image_size(self, width: int, height: int) -> None:
        self._invalidate(
            calibration=replace(
                self._config.calibration, image_width=width, image_height=height
            )
        )

    def set_undistortion_new_image_size(self, width: int, height: int) -> None:
        # scales the rectified camera matrix; maps/output stay at the
        # calibration size (undistortion.cpp:28-31, 216-238)
        self._set_module("undistortion", new_image_size=(width, height))

    def set_undistortion_balance(self, balance: float) -> None:
        self._set_module("undistortion", balance=balance)

    def set_undistortion_fov_scale(self, fov_scale: float) -> None:
        self._set_module("undistortion", fov_scale=fov_scale)

    def set_undistortion_interpolation(self, mode: str) -> None:
        """Pick which OpenCV-build remap arithmetic to replicate (an
        extension; the reference's output is build-dependent here):
        "lerp" (x86/IPP, default) | "fixed32" (ARM/Jetson — the
        reference's deployment) | "float" (quantization-free)."""
        if mode not in ("lerp", "fixed32", "float"):
            raise ValueError(f"unknown remap interpolation [{mode}]")
        self._set_module("undistortion", interpolation=mode)

    def set_undistortion_camera_matrix(self, camera_matrix) -> None:
        self._invalidate(
            calibration=replace(
                self._config.calibration,
                camera_matrix=tuple(np.asarray(camera_matrix, float).ravel()),
                calibration_available=True,
            )
        )

    def set_undistortion_distortion_coeffs(self, coeffs) -> None:
        self._invalidate(
            calibration=replace(
                self._config.calibration,
                distortion_coefficients=tuple(np.asarray(coeffs, float).ravel()),
            )
        )

    def set_undistortion_distortion_model(self, model: str) -> None:
        self._invalidate(
            calibration=replace(self._config.calibration, distortion_model=model)
        )

    def set_undistortion_rectification_matrix(self, matrix) -> None:
        self._invalidate(
            calibration=replace(
                self._config.calibration,
                rectification_matrix=tuple(np.asarray(matrix, float).ravel()),
            )
        )

    def set_undistortion_projection_matrix(self, matrix) -> None:
        self._invalidate(
            calibration=replace(
                self._config.calibration,
                projection_matrix=tuple(np.asarray(matrix, float).ravel()),
            )
        )

    # ------------------------------------------------------------------
    # getters (raw_image_pipeline.hpp:106-137; undistortion.cpp:78-152)
    # ------------------------------------------------------------------

    def _rect_size(self):
        c = self._config.calibration
        return self._config.undistortion.new_image_size or (c.image_width, c.image_height)

    def _rect_K(self) -> np.ndarray:
        c = self._config.calibration
        size = (c.image_width, c.image_height)
        from raw_image_pipeline_tpu.ops.undistortion import estimate_new_camera_matrix

        return estimate_new_camera_matrix(
            c.K(), c.D(), size, c.R(),
            self._config.undistortion.balance, self._rect_size(),
            self._config.undistortion.fov_scale,
        )

    def get_dist_image_height(self) -> int:
        return self._config.calibration.image_height

    def get_dist_image_width(self) -> int:
        return self._config.calibration.image_width

    def get_rect_image_height(self) -> int:
        return self._rect_size()[1]

    def get_rect_image_width(self) -> int:
        return self._rect_size()[0]

    def get_dist_distortion_model(self) -> str:
        c = self._config.calibration
        return c.distortion_model if c.calibration_available else "none"

    def get_rect_distortion_model(self) -> str:
        c = self._config.calibration
        if not c.calibration_available:
            return "none"
        # once rectified there is no distortion left (undistortion.cpp:93-103)
        return "none" if self._config.undistortion.enabled else c.distortion_model

    def get_dist_camera_matrix(self) -> np.ndarray:
        return self._config.calibration.K()

    def get_rect_camera_matrix(self) -> np.ndarray:
        c = self._config.calibration
        if c.calibration_available and c.distortion_model != "none":
            return self._rect_K()
        return c.K()

    def get_dist_distortion_coefficients(self) -> np.ndarray:
        return self._config.calibration.D().reshape(1, 4)

    def get_rect_distortion_coefficients(self) -> np.ndarray:
        return np.zeros((1, 4))

    def get_dist_rectification_matrix(self) -> np.ndarray:
        return self._config.calibration.R()

    def get_rect_rectification_matrix(self) -> np.ndarray:
        return np.eye(3)

    def get_dist_projection_matrix(self) -> np.ndarray:
        return self._config.calibration.P()

    def get_rect_projection_matrix(self) -> np.ndarray:
        c = self._config.calibration
        P = np.zeros((3, 4))
        P[:3, :3] = self.get_rect_camera_matrix()
        if not (c.calibration_available and c.distortion_model != "none"):
            P = c.P()
        return P

    # ------------------------------------------------------------------
    # is-enabled getters (raw_image_pipeline.cpp:491-520)
    # ------------------------------------------------------------------

    def is_debayer_enabled(self) -> bool:
        return self._config.debayer.enabled

    def is_flip_enabled(self) -> bool:
        return self._config.flip.enabled

    def is_white_balance_enabled(self) -> bool:
        return self._config.white_balance.enabled

    def is_color_calibration_enabled(self) -> bool:
        return self._config.color_calibration.enabled

    def is_gamma_correction_enabled(self) -> bool:
        return self._config.gamma_correction.enabled

    def is_vignetting_correction_enabled(self) -> bool:
        return self._config.vignetting_correction.enabled

    def is_color_enhancer_enabled(self) -> bool:
        return self._config.color_enhancer.enabled

    def is_undistortion_enabled(self) -> bool:
        return self._config.undistortion.enabled
