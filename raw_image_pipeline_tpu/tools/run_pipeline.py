"""Batch/stream CLI — the production entry point replacing the reference
ROS node (raw_image_pipeline_ros): read frames from a directory, process
them through the jitted ISP in batches, write the output streams as PNGs
plus a camera_info YAML sidecar with the dist/rect calibrations.

Example:
    python -m raw_image_pipeline_tpu.tools.run_pipeline \
        -i frames/ -o out/ -e bayer_gbrg8 \
        -p configs/pipeline_params_example.yaml \
        -c configs/alphasense_calib_example.yaml
"""

from __future__ import annotations

import argparse
import glob
import os

import cv2
import numpy as np

from raw_image_pipeline_tpu import RawImagePipeline
from raw_image_pipeline_tpu.config import (
    DEFAULT_CALIBRATION_PATH,
    DEFAULT_COLOR_CALIBRATION_PATH,
    DEFAULT_PARAMS_PATH,
    dump_yaml,
    load_camera_calibration,
    load_color_calibration,
    load_pipeline_params,
)
from raw_image_pipeline_tpu.runtime.stream import StreamRunner, make_camera_infos


def main(argv=None):
    from raw_image_pipeline_tpu.utils.compile_cache import (
        enable_compilation_cache,
    )

    enable_compilation_cache()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--input-dir",
                    help="directory of frames (required unless --listen)")
    ap.add_argument("-o", "--output-dir", required=True)
    ap.add_argument("-e", "--encoding", default="bayer_gbrg8",
                    help="input encoding (the ROS input topic encoding)")
    ap.add_argument("-p", "--params", default=DEFAULT_PARAMS_PATH)
    ap.add_argument("-c", "--calibration", default=DEFAULT_CALIBRATION_PATH)
    ap.add_argument("-cc", "--color-calibration", default=DEFAULT_COLOR_CALIBRATION_PATH)
    ap.add_argument("-b", "--batch", type=int, default=8)
    ap.add_argument("--output-encoding", default="BGR", choices=["BGR", "RGB"])
    ap.add_argument("--skip-slow", type=int, default=0,
                    help="emit a color/slow stream every N frames (ROS /slow topics)")
    ap.add_argument("--output-frame", default="passthrough",
                    help="frame_id recorded in camera_info.yaml "
                         "(ROS output_frame; 'passthrough' keeps the source)")
    ap.add_argument("--raw-shape", default=None,
                    help="treat *.raw inputs as headerless HxW (e.g. 540x720) "
                         "8-bit frames, streamed by the native C++ frame pump")
    ap.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="live mode: ingest frames over TCP "
                         "(runtime.sources.SocketFrameSource wire format; "
                         "queue-size-1 drop-to-newest like the reference "
                         "node's subscription) instead of reading files; "
                         "requires --raw-shape for the frame geometry")
    ap.add_argument("--remap-interpolation", default=None,
                    choices=["lerp", "fixed32", "float"],
                    help="which OpenCV-build remap arithmetic to replicate "
                         "(default from config: lerp = x86/IPP; fixed32 = "
                         "ARM/Jetson — the reference's deployment; see "
                         "ops/undistortion.remap_precompute)")
    ap.add_argument("--control", default=None, metavar="HOST:PORT",
                    help="with --listen: TCP line-protocol control channel "
                         "(runtime.control.ControlServer) exposing the "
                         "reference node's runtime services — "
                         "reset_white_balance (~reset_white_balance) and "
                         "reload_params [path] (dynamic reconfigure)")
    args = ap.parse_args(argv)

    if args.listen:
        return _run_live(args)
    if not args.input_dir:
        raise SystemExit("--input-dir is required unless --listen is given")

    raw_mode = args.raw_shape is not None
    exts = ("raw",) if raw_mode else ("png", "jpg", "jpeg", "tiff")
    paths = sorted(
        p for ext in exts
        for p in glob.glob(os.path.join(args.input_dir, f"*.{ext}"))
    )
    if not paths:
        raise SystemExit(f"no frames found in {args.input_dir}")

    api = RawImagePipeline(False, args.params, args.calibration, args.color_calibration)
    if args.remap_interpolation:
        api.set_undistortion_interpolation(args.remap_interpolation)
    if raw_mode:
        h, w = (int(x) for x in args.raw_shape.lower().split("x"))
        first = np.zeros((h, w), np.uint8)
    else:
        first = cv2.imread(paths[0], cv2.IMREAD_UNCHANGED)

    config = load_pipeline_params(args.params)
    config = config.replace(
        calibration=load_camera_calibration(args.calibration),
        color_calibration=load_color_calibration(
            args.color_calibration, config.color_calibration
        ),
    )
    if args.remap_interpolation:
        import dataclasses as _dc

        config = config.replace(undistortion=_dc.replace(
            config.undistortion, interpolation=args.remap_interpolation))
    runner = StreamRunner(
        config, args.encoding, first.shape[:2], batch_size=args.batch,
        output_encoding=args.output_encoding, slow_skip=args.skip_slow,
    )

    os.makedirs(args.output_dir, exist_ok=True)
    infos = make_camera_infos(api, output_frame=args.output_frame)
    with open(os.path.join(args.output_dir, "camera_info.yaml"), "w") as f:
        f.write(dump_yaml({k: v.to_dict() for k, v in infos.items()}))

    names = [os.path.splitext(os.path.basename(p))[0] for p in paths]

    # PNG encoding is CPU-bound and cv2.imwrite holds the GIL; the native
    # writer pool (native/frame_sink.cpp) encodes on worker threads and
    # backpressures via its bounded queue. Falls back to Python writes.
    from raw_image_pipeline_tpu.runtime.native import (
        FrameSink,
        native_sink_available,
    )

    pool = FrameSink() if native_sink_available() else None
    made_dirs = set()

    def sink(stream, idx, img):
        d = os.path.join(args.output_dir, stream.replace("/", "_"))
        if d not in made_dirs:
            os.makedirs(d, exist_ok=True)
            made_dirs.add(d)
        path = os.path.join(d, names[idx] + ".png")
        if pool is not None:
            pool.write(path, img)
        else:
            cv2.imwrite(path, img)

    def frames():
        if raw_mode:
            # native C++ threaded reader overlapping IO with compute
            from raw_image_pipeline_tpu.runtime.native import (
                FramePump,
                native_available,
            )

            if native_available():
                pump = FramePump(paths, first.shape, batch=args.batch)
                for batch in pump:
                    yield from batch
                return
            for p in paths:
                yield np.fromfile(p, np.uint8, count=first.size).reshape(first.shape)
        else:
            for p in paths:
                yield cv2.imread(p, cv2.IMREAD_UNCHANGED)

    failures = 0
    try:
        n = runner.run(frames(), sink)
    finally:
        # flush/close even when the run or a sink raised: queued frames are
        # written (not abandoned) and encode failures surface
        if pool is not None:
            failures = pool.flush()
            pool.close()
    if failures:
        raise SystemExit(f"{failures} output writes failed")
    print(f"processed {n} frames -> {args.output_dir}")


def _run_live(args):
    """--listen mode: one frame per dispatch from a live TCP source (the
    reference node's operating mode — process the newest frame, drop the
    rest), writing numbered outputs until the source is closed (producer
    side) or Ctrl-C."""
    from raw_image_pipeline_tpu.runtime.sources import SocketFrameSource

    if args.raw_shape is None:
        raise SystemExit("--listen requires --raw-shape HxW")
    h, w = (int(x) for x in args.raw_shape.lower().split("x"))

    api = RawImagePipeline(False, args.params, args.calibration,
                           args.color_calibration)
    if args.remap_interpolation:
        api.set_undistortion_interpolation(args.remap_interpolation)
    os.makedirs(args.output_dir, exist_ok=True)
    infos = make_camera_infos(api, output_frame=args.output_frame)
    with open(os.path.join(args.output_dir, "camera_info.yaml"), "w") as f:
        f.write(dump_yaml({k: v.to_dict() for k, v in infos.items()}))

    host, _, port = args.listen.partition(":")
    src = SocketFrameSource(host or "127.0.0.1", int(port or 0))
    print(f"listening on {src.address[0]}:{src.address[1]}", flush=True)

    ctrl = None
    if args.control:
        from raw_image_pipeline_tpu.runtime.control import ControlServer

        def _reload(path=None):
            api.load_params(path or args.params)
            return "params reloaded"

        chost, _, cport = args.control.partition(":")
        ctrl = ControlServer(
            {
                "reset_white_balance":
                    api.reset_white_balance_temporal_consistency,
                "reload_params": _reload,
            },
            chost or "127.0.0.1", int(cport or 0),
        )
        print(f"control on {ctrl.address[0]}:{ctrl.address[1]}", flush=True)

    n = 0
    try:
        for frame in src:
            if frame.shape[:2] != (h, w):
                print(f"skipping frame with shape {frame.shape} != {h}x{w}")
                continue
            out = api.process(frame, args.encoding)
            if args.output_encoding == "RGB" and out.ndim == 3:
                out = out[..., ::-1]
            cv2.imwrite(os.path.join(args.output_dir, f"{n:06d}.png"), out)
            n += 1
    except KeyboardInterrupt:
        pass
    finally:
        if ctrl is not None:
            ctrl.close()
        src.close()
    print(f"processed {n} live frames ({src.dropped} dropped) "
          f"-> {args.output_dir}")
    return n


if __name__ == "__main__":
    main()
