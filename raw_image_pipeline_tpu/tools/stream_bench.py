"""Tool: end-to-end StreamRunner throughput on the accelerator from a real
frame directory (native pump -> double-buffered H2D -> full chain -> sink).

Run from the repo root: python -m raw_image_pipeline_tpu.tools.stream_bench
The raw frames are written under .scratch/stream_frames in the checkout."""
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    from raw_image_pipeline_tpu.utils.compile_cache import (
        enable_compilation_cache,
    )

    enable_compilation_cache()
    import jax
    import __graft_entry__ as ge
    from raw_image_pipeline_tpu.runtime.native import FramePump, native_available
    from raw_image_pipeline_tpu.runtime.stream import StreamRunner

    h, w = 1080, 1920
    n_frames = 256
    d = os.path.join(os.path.dirname(os.path.abspath(ge.__file__)),
                     ".scratch", "stream_frames")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (h, w), np.uint8)
    for i in range(n_frames):
        path = os.path.join(d, f"frame_{i:04d}.raw")
        if not os.path.exists(path):
            # vary content cheaply
            np.roll(frame, i, axis=1).tofile(path)
    log(f"{n_frames} raw frames in {d}; native pump available: {native_available()}")

    config = ge._full_config((h, w))
    runner = StreamRunner(config, "bayer_gbrg8", (h, w), batch_size=32)

    counts = {"color": 0, "color_rect": 0}

    def sink(stream, idx, img):
        counts[stream] = counts.get(stream, 0) + 1

    files = sorted(os.path.join(d, f) for f in os.listdir(d))
    pump = FramePump(files, (h, w), batch=32)

    # warm compile at the REAL batch shape (and the tail shape)
    t0 = time.perf_counter()
    runner.run([frame] * 32, lambda *a: None)
    log(f"compile+warm: {time.perf_counter()-t0:.1f}s")

    t0 = time.perf_counter()
    n = runner.run((fr for batch in pump for fr in batch), sink)
    dt = time.perf_counter() - t0
    log(f"streamed {n} frames in {dt:.2f}s = {n/dt:.1f} frames/s end-to-end "
        f"(disk->pump->H2D->chain->D2H->sink, 3 full-res streams fetched); "
        f"sink calls: {counts} on {jax.devices()[0].device_kind}")

    # fetch-light variant: consume only a tiny slice of each output, so
    # the difference to the run above is the D2H readback
    pump2 = FramePump(files, (h, w), batch=32)
    t0 = time.perf_counter()
    n = runner.run((fr for batch in pump2 for fr in batch),
                   lambda s_, i, img: img[0, 0] if hasattr(img, '__getitem__') else None)
    dt = time.perf_counter() - t0
    log(f"streamed {n} frames in {dt:.2f}s = {n/dt:.1f} frames/s "
        f"(same path, sink reads 1 px/frame)")


if __name__ == "__main__":
    main()
