"""Streaming runner — the role the ROS node plays in the reference
(raw_image_pipeline_ros.cpp:219-368), batch-shaped.

Instead of one frame per callback, frames are drained from a source in
batches, processed by the jitted pipeline (optionally sharded over a device
mesh), and handed to a sink together with the camera_info-equivalent
calibration metadata. Cross-frame CCC state is carried explicitly.

Publishes the same three streams as the reference node:
  * "color"     — the processed image before undistortion (the reference's
    <output>/color topic publishes the pre-undistort snapshot when
    undistortion is on — quirk §8.7 — replicated);
  * "color_rect" — the rectified image (when undistortion runs);
  * "debayered" — the post-flip debayer snapshot (when input is Bayer).
A `slow_skip` count gates a decimated variant of each stream, mirroring the
reference's /slow topics (raw_image_pipeline_ros.cpp:337-360).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List

import jax
import numpy as np

from raw_image_pipeline_tpu.config import PipelineConfig
from raw_image_pipeline_tpu.pipeline import BuiltPipeline, build_pipeline, init_state


@dataclasses.dataclass
class CameraInfo:
    """camera_info-equivalent metadata (raw_image_pipeline_ros.cpp:297-336).

    frame_id mirrors the node's `output_frame` option: "passthrough" keeps
    the source frame id (raw_image_pipeline_ros.cpp:307-311)."""

    width: int
    height: int
    distortion_model: str
    D: List[float]
    K: List[float]
    R: List[float]
    P: List[float]
    frame_id: str = "passthrough"

    def to_dict(self):
        return dataclasses.asdict(self)


def make_camera_infos(api_pipeline, output_frame: str = "passthrough") -> Dict[str, CameraInfo]:
    """Build dist and rect CameraInfo from a RawImagePipeline, fixing the
    model string to plumb_bob when "none" like the reference
    (raw_image_pipeline_ros.cpp:318-320)."""

    def fix(model):
        return "plumb_bob" if model == "none" else model

    def fl(a):
        return [float(x) for x in np.asarray(a).ravel()]

    dist = CameraInfo(
        width=api_pipeline.get_dist_image_width(),
        height=api_pipeline.get_dist_image_height(),
        distortion_model=fix(api_pipeline.get_dist_distortion_model()),
        D=fl(api_pipeline.get_dist_distortion_coefficients()),
        K=fl(api_pipeline.get_dist_camera_matrix()),
        R=fl(api_pipeline.get_dist_rectification_matrix()),
        P=fl(api_pipeline.get_dist_projection_matrix()),
        frame_id=output_frame,
    )
    rect = CameraInfo(
        width=api_pipeline.get_rect_image_width(),
        height=api_pipeline.get_rect_image_height(),
        distortion_model=fix(api_pipeline.get_rect_distortion_model()),
        D=fl(api_pipeline.get_rect_distortion_coefficients()),
        K=fl(api_pipeline.get_rect_camera_matrix()),
        R=fl(api_pipeline.get_rect_rectification_matrix()),
        P=fl(api_pipeline.get_rect_projection_matrix()),
        frame_id=output_frame,
    )
    return {"dist": dist, "rect": rect}


class StreamRunner:
    """Batched streaming executor with carried CCC state."""

    def __init__(
        self,
        config: PipelineConfig,
        encoding: str,
        frame_hw,
        batch_size: int = 8,
        output_encoding: str = "BGR",
        slow_skip: int = 0,
        mesh=None,
        microbatch=None,
    ):
        self.config = config
        self.encoding = encoding
        self.batch_size = batch_size
        self.output_encoding = output_encoding
        self.slow_skip = slow_skip
        self.mesh = mesh
        wb = config.white_balance
        self.with_state = wb.enabled and wb.method == "ccc" and wb.temporal_consistency
        self.pipe: BuiltPipeline = build_pipeline(
            config, encoding, frame_hw=frame_hw,
            with_state=self.with_state, keep_intermediates=True,
            temporal_mode="sequence",
            # bound peak device memory for very large batch_size (see build_pipeline)
            microbatch=microbatch,
            # every dispatch stages a fresh host batch, so the previous
            # device input is dead the moment the program runs — donating
            # it gives the steady state one batch worth of device-memory headroom
            # (CPU can't alias these buffers and would warn every dispatch)
            donate=jax.default_backend() != "cpu",
        )
        # one shared illuminant track, like the reference's single camera
        # stream; batch entries advance it sequentially via scan semantics
        self.state = init_state(()) if self.with_state else None
        self._slow_counter = 0

    def reset_white_balance(self):
        """The ~reset_white_balance service (raw_image_pipeline_ros.cpp:290-295)."""
        if self.with_state:
            self.state = init_state(())

    def run(
        self,
        frames: Iterable[np.ndarray],
        sink: Callable[[str, int, np.ndarray], None],
    ) -> int:
        """Drain `frames`, calling sink(stream_name, frame_index, image).
        Returns the number of frames processed.

        Execution is double-buffered: each batch is staged to the device
        (async host->device copy) and its pipeline dispatch issued BEFORE
        the previous batch's outputs are fetched and handed to the sink —
        so disk IO (the native pump), H2D staging, device compute and D2H
        readback of consecutive batches overlap.
        """
        count = 0
        buf: List[np.ndarray] = []
        in_flight = None  # (n_frames, outputs dict of device arrays)

        def emit(n, outputs):
            nonlocal count
            outputs = {k: np.asarray(v) for k, v in outputs.items()}
            for i in range(n):
                idx = count + i
                # reference publishes: color (pre-undistort snapshot when
                # rectifying, else the processed image), color_rect,
                # debayered (raw_image_pipeline_ros.cpp:240-288)
                color = outputs.get("dist_color", outputs["processed"])[i]
                sink("color", idx, self._encode(color))
                if self.config.undistortion.enabled:
                    sink("color_rect", idx, self._encode(outputs["processed"][i]))
                if "debayered" in outputs:
                    sink("debayered", idx, self._encode(outputs["debayered"][i]))
                if self.slow_skip > 0:
                    self._slow_counter += 1
                    if self._slow_counter > self.slow_skip:
                        self._slow_counter = 0
                        sink("color/slow", idx, self._encode(color))
            count += n

        def dispatch(batch: np.ndarray):
            nonlocal in_flight
            n = batch.shape[0]
            if n < self.batch_size and not self.with_state:
                # pad the tail batch up to the traced batch size so it
                # reuses the compiled program instead of paying a one-off
                # retrace (~tens of seconds); emit() only reads the first
                # n entries. Stateful runs can't pad — the Kalman scan
                # would advance the illuminant track over the pad frames —
                # so they accept the tail retrace instead.
                pad = np.repeat(batch[-1:], self.batch_size - n, axis=0)
                batch = np.concatenate([batch, pad])
            if self.mesh is not None:
                from raw_image_pipeline_tpu.parallel.mesh import shard_batch

                dev = shard_batch(batch, self.mesh)
            else:
                dev = jax.device_put(batch)  # async H2D staging
            if self.with_state:
                outputs, self.state = self.pipe(dev, self.state)
            else:
                outputs, _ = self.pipe(dev, None)
            prev = in_flight
            in_flight = (n, outputs)
            if prev is not None:
                emit(*prev)  # fetch previous batch while this one computes

        for frame in frames:
            buf.append(np.asarray(frame))
            if len(buf) >= self.batch_size:
                dispatch(np.stack(buf))
                buf.clear()
        if buf:
            dispatch(np.stack(buf))
        if in_flight is not None:
            emit(*in_flight)
        return count

    def _encode(self, img: np.ndarray) -> np.ndarray:
        if self.output_encoding.upper() == "RGB" and img.ndim == 3 and img.shape[-1] == 3:
            return img[..., ::-1]
        return img
