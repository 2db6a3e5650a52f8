"""Pod-scale data-parallel bench for the full ISP chain.

The one command for the multi-host data-parallel run (the BASELINE >=80%
scaling target), on one or several GPU hosts:

    # on every host of the slice (or under a pod launcher that sets the
    # JAX distributed env):
    python -m raw_image_pipeline_tpu.tools.pod_bench \
        --coordinator HOST0:1234 --num-processes N --process-id I

It initializes jax.distributed, forms the global 1-D data mesh over every
device of every process, builds the full 9-stage pipeline, ingests per-host frame
shards through the production path (make_array_from_process_local_data),
times K back-to-back dispatches of the global program, and reports
per-host + aggregate frames/s plus scaling efficiency against a
single-chip run of the same per-chip batch measured in the same process.

Under a launcher that pre-sets the JAX distributed environment, run with
no flags: jax.distributed.initialize() auto-detects. Single-process
(1 host, >=1 devices) also works — efficiency is then device scaling on
one host.

The 2-process CPU smoke in tests/test_pod_bench.py runs THIS script
end-to-end every CI run, so the command is known-good before hardware
shows up. Reference has no counterpart: strictly single-process
(raw_image_pipeline_ros.cpp:185).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--coordinator", default=None,
                    help="coordinator address host:port (process 0's host)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--batch-per-device", type=int, default=64)
    ap.add_argument("--k-dispatch", type=int, default=6,
                    help="back-to-back dispatches per timing round")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="CPU smoke mode (CI): force the CPU backend")
    ap.add_argument("--local-devices", type=int, default=None,
                    help="with --cpu: virtual CPU devices per process")
    args = ap.parse_args(argv)
    if args.k_dispatch < 1:
        ap.error("--k-dispatch must be >= 1")

    if args.cpu:
        if args.local_devices:
            os.environ["XLA_FLAGS"] = (
                f"--xla_force_host_platform_device_count={args.local_devices} "
                + os.environ.get("XLA_FLAGS", "")
            )
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

    import jax.numpy as jnp
    import numpy as np

    from raw_image_pipeline_tpu.parallel.multihost import (
        distribute_batch,
        global_data_mesh,
        initialize_multihost,
    )
    from raw_image_pipeline_tpu.pipeline import build_pipeline

    if args.num_processes is not None and args.num_processes > 1:
        initialize_multihost(args.coordinator, args.num_processes,
                             args.process_id)
    elif not args.cpu and os.environ.get("JAX_COORDINATOR_ADDRESS"):
        # scheduler-provided distributed env: auto-detect
        jax.distributed.initialize()

    pid = jax.process_index()
    n_proc = jax.process_count()
    n_dev = jax.device_count()
    n_local = jax.local_device_count()
    log(f"[pod_bench] proc {pid}/{n_proc}, {n_local} local / {n_dev} global "
        f"devices ({jax.devices()[0].platform})")

    h, w = args.height, args.width
    import __graft_entry__ as ge  # repo-root flagship config

    config = ge._full_config((h, w))
    mesh = global_data_mesh()
    pipe = build_pipeline(config, "bayer_gbrg8", frame_hw=(h, w))
    params = jax.device_put(pipe.params)

    # per-host ingest of the host's own shard only (the production path)
    b_local = args.batch_per_device * n_local
    rng = np.random.default_rng(1234 + pid)
    local = rng.integers(0, 256, (b_local, h, w), np.uint8)
    gbatch = distribute_batch(local, mesh)
    b_global = args.batch_per_device * n_dev

    step = jax.jit(lambda p, x: jnp.sum(
        pipe.fn(p, x, None)[0]["processed"], dtype=jnp.int32))

    t0 = time.perf_counter()
    np.asarray(step(params, gbatch))
    log(f"[pod_bench] compile+first: {time.perf_counter() - t0:.1f}s")

    # the shared K-dispatch steady-state recipe (bench.py at the repo
    # root — pod_bench already runs from there for __graft_entry__)
    from bench import steady_per_frame

    k = args.k_dispatch
    spf = steady_per_frame(lambda: step(params, gbatch), b_global,
                           k=k, rounds=args.rounds)
    global_fps = 1.0 / spf

    # single-chip arm, same process, same per-chip batch: the efficiency
    # denominator.
    dev0 = jax.local_devices()[0]
    pipe1 = build_pipeline(config, "bayer_gbrg8", frame_hw=(h, w))
    params1 = jax.device_put(pipe1.params, dev0)
    one = jax.device_put(local[: args.batch_per_device], dev0)
    step1 = jax.jit(lambda p, x: jnp.sum(
        pipe1.fn(p, x, None)[0]["processed"], dtype=jnp.int32))
    np.asarray(step1(params1, one))
    spf1 = steady_per_frame(lambda: step1(params1, one),
                            args.batch_per_device, k=k,
                            rounds=args.rounds)
    chip_fps = 1.0 / spf1
    efficiency = global_fps / (chip_fps * n_dev)

    result = {
        "metric": "pod_scaling_full_isp",
        "frame": f"{w}x{h}",
        "processes": n_proc,
        "devices": n_dev,
        "batch_per_device": args.batch_per_device,
        "global_fps": round(global_fps, 1),
        "per_host_fps": round(global_fps / n_proc, 1),
        "single_chip_fps": round(chip_fps, 1),
        "scaling_efficiency": round(efficiency, 4),
    }
    log(f"[pod_bench] proc {pid}: {json.dumps(result)}")
    if pid == 0:
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
