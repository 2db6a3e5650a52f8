"""Benchmark: frames/s per GPU for the full 9-stage ISP chain on 1080p Bayer
frames (BASELINE.json primary metric), plus per-config numbers for
BASELINE.json configs 1-6 on stderr.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "frames/s", "vs_baseline": R,
   "device": {"platform", "kind", "count"}, ...}

Needs a GPU: it exits non-zero when JAX's first device is not one. Every
time is host wall time around work that ends in block_until_ready. A
failing config fails the run. Exactness is not checked here; chip_smoke.py
checks the chain against the CPU backend.
"""

import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_noise(shape, seed, dtype=None):
    """Pseudorandom u8 test frames generated on the device in one dispatch
    (a multi-GB batch costs no host work or transfer)."""
    import jax
    import jax.numpy as jnp

    dtype = dtype or jnp.uint8
    fn = jax.jit(
        lambda: jax.random.randint(
            jax.random.PRNGKey(seed), shape, 0, 256, jnp.int32
        ).astype(dtype)
    )
    out = fn()
    out.block_until_ready()
    return out


def _timed(step, *args, repeats=5):
    """Min wall time of one dispatch of step(*args) to its completion."""
    import jax

    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(step(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def steady_per_frame(step, batch, k=6, rounds=3):
    """Seconds per frame over k back-to-back dispatches ending in one
    block_until_ready (the production dispatch rate: the host enqueues the
    next step while the device runs the last). step: zero-arg dispatch."""
    import jax

    jax.block_until_ready(step())  # warm
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        r = None
        for _ in range(k):
            r = step()
        jax.block_until_ready(r)
        best = min(best, time.perf_counter() - t0)
    return best / (k * batch)


def _chain_step(pipe, with_state=False):
    """Jitted step returning a checksum of `processed` (and the state)."""
    import jax
    import jax.numpy as jnp

    if with_state:
        @jax.jit
        def step(p, px, st):
            out, st2 = pipe.fn(p, px, st)
            return jnp.sum(out["processed"], dtype=jnp.int32), st2
        return step

    @jax.jit
    def step(p, px):
        out, _ = pipe.fn(p, px, None)
        return jnp.sum(out["processed"], dtype=jnp.int32)
    return step


def chain_fps(h=1080, w=1920, batch=64, tag="full chain"):
    """Headline: steady full-chain throughput at `batch` frames per
    dispatch. Returns {"fps", "ms_per_step", "batch", "compile_s"}."""
    import jax

    import __graft_entry__ as ge
    from raw_image_pipeline_tpu.pipeline import build_pipeline

    pipe = build_pipeline(ge._full_config((h, w)), "bayer_gbrg8",
                          frame_hw=(h, w))
    params = jax.device_put(pipe.params)
    step = _chain_step(pipe)
    pix = device_noise((batch, h, w), batch)
    t0 = time.perf_counter()
    jax.block_until_ready(step(params, pix))
    compile_s = time.perf_counter() - t0
    spf = steady_per_frame(lambda: step(params, pix), batch)
    pix.delete()
    log(f"{tag} {w}x{h} B={batch}: {1 / spf:.1f} frames/s "
        f"({spf * batch * 1e3:.2f} ms/step; compile+first {compile_s:.1f} s)")
    return {"fps": 1.0 / spf, "ms_per_step": spf * batch * 1e3,
            "batch": batch, "compile_s": compile_s}


def config_benchmarks(h=1080, w=1920):
    """Per-config numbers for BASELINE.json configs 1-6 (stderr report)."""
    import dataclasses

    import jax

    import __graft_entry__ as ge
    from raw_image_pipeline_tpu.config import PipelineConfig
    from raw_image_pipeline_tpu.parallel.multicamera import (
        build_multicamera_pipeline,
    )
    from raw_image_pipeline_tpu.pipeline import build_pipeline, init_state

    results = {}

    def record(key, val):
        results[key] = val
        log(f"  {key}: {val}")

    full = ge._full_config((h, w))

    # --- config 1: debayer + gamma(default), single 1920x1080 frame -------
    cfg1 = PipelineConfig(
        gamma_correction=dataclasses.replace(
            full.gamma_correction, enabled=True, method="default", k=0.9
        )
    )
    pipe1 = build_pipeline(cfg1, "bayer_gbrg8", frame_hw=(h, w))
    p1 = jax.device_put(pipe1.params)
    step1 = _chain_step(pipe1)
    one = device_noise((1, h, w), 11)
    jax.block_until_ready(step1(p1, one))
    lat = _timed(step1, p1, one, repeats=20)
    b64 = device_noise((64, h, w), 13)
    s1 = steady_per_frame(lambda: step1(p1, b64), 64)
    record("config1_debayer_gamma", {
        "single_frame_dispatch_ms": round(lat * 1e3, 3),
        "steady_state_fps_b64": round(1 / s1, 1),
    })
    one.delete()
    b64.delete()

    # --- config 2: debayer + flip + grey_world WB, batch 64 ---------------
    cfg2 = PipelineConfig(
        flip=dataclasses.replace(full.flip, enabled=True, angle=180),
        white_balance=dataclasses.replace(
            full.white_balance, enabled=True, method="grey_world",
            temporal_consistency=False,
        ),
    )
    pipe2 = build_pipeline(cfg2, "bayer_gbrg8", frame_hw=(h, w))
    p2 = jax.device_put(pipe2.params)
    step2 = _chain_step(pipe2)
    b2 = device_noise((64, h, w), 22)
    s2 = steady_per_frame(lambda: step2(p2, b2), 64)
    record("config2_debayer_flip_greyworld_b64", {
        "steady_state_us_per_frame": round(s2 * 1e6, 1),
        "steady_state_fps": round(1 / s2, 1),
    })
    b2.delete()

    # --- config 3: full chain + CCC + Kalman temporal consistency ---------
    pipe3 = build_pipeline(full, "bayer_gbrg8", frame_hw=(h, w),
                           with_state=True, temporal_mode="sequence")
    p3 = jax.device_put(pipe3.params)
    step3 = _chain_step(pipe3, with_state=True)
    st = init_state(())
    b3 = device_noise((64, h, w), 32)
    s3 = steady_per_frame(lambda: step3(p3, b3, st)[0], 64)
    record("config3_streamed_ccc_kalman_b64", {
        "steady_state_us_per_frame": round(s3 * 1e6, 1),
        "steady_state_fps": round(1 / s3, 1),
    })
    b3.delete()

    # --- config 4: colorcal + vignetting + HSV enhancement, batch 512 -----
    cfg4 = PipelineConfig(
        color_calibration=dataclasses.replace(
            full.color_calibration, enabled=True
        ),
        vignetting_correction=dataclasses.replace(
            full.vignetting_correction, enabled=True, scale=1.5, a2=1e-3,
            a4=1e-6,
        ),
        color_enhancer=dataclasses.replace(
            full.color_enhancer, enabled=True, saturation_gain=1.2
        ),
    )
    pipe4 = build_pipeline(cfg4, "bgr8", frame_hw=(h, w), microbatch=128)
    p4 = jax.device_put(pipe4.params)
    step4 = _chain_step(pipe4)
    b4 = device_noise((512, h, w, 3), 42)
    s4 = steady_per_frame(lambda: step4(p4, b4), 512, k=3)
    record("config4_pointwise_b512_microbatch128", {
        "steady_state_us_per_frame": round(s4 * 1e6, 1),
        "steady_state_fps": round(1 / s4, 1),
    })
    b4.delete()

    # --- config 5: full chain, 4 cameras, DISTINCT calibrations -----------
    # Camera-blocked build (no vmap — see parallel/multicamera.py): shared
    # stages run at the full 4B batch; each camera's block goes through its
    # own undistortion map.
    def perturb(calib, s):
        k = list(calib.camera_matrix)
        k[0] *= s
        k[4] *= s
        return dataclasses.replace(calib, camera_matrix=tuple(k))

    calibs = [perturb(full.calibration, s) for s in (1.0, 1.02, 0.98, 1.04)]
    mc = build_multicamera_pipeline(full, calibs, "bayer_gbrg8",
                                    frame_hw=(h, w))
    pmc = jax.device_put(mc.params)
    step5 = _chain_step(mc)
    c5 = device_noise((4, 64, h, w), 52)
    s5 = steady_per_frame(lambda: step5(pmc, c5), 4 * 64)
    record("config5_multicamera_4x_distinct_calibs_b64", {
        "steady_state_us_per_frame": round(s5 * 1e6, 1),
        "steady_state_fps": round(1 / s5, 1),
    })
    c5.delete()

    # --- config 6: the reference's own 1.6 MP Alphasense frame size -------
    # (alphasense_calib_1.6mp_example.yaml: 1440x1080), full 9-stage chain
    r6 = chain_fps(h=1080, w=1440, tag="config6 1.6MP full chain")
    record("config6_alphasense_1.6mp_full_chain_b64", {
        "steady_state_fps": round(r6["fps"], 1),
    })
    return results


# Frozen canonical CPU-arm number for the vs_baseline denominator: the
# opencv-python composition of the same chain, pinned cv2.setNumThreads(4),
# min-of-12 per-frame, best of 3 runs on an idle x86 host (2026-08-18:
# 11.98 / 11.35 / 10.45 f/s).
CANONICAL_CPU_FPS = 11.98


def scaling(h=1080, w=1920, per_dev_batch=64):
    """Data-parallel scaling efficiency when >1 device is attached (the
    BASELINE >=80% target); None on single-device hosts."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import __graft_entry__ as ge
    from raw_image_pipeline_tpu.parallel.mesh import make_mesh
    from raw_image_pipeline_tpu.pipeline import build_pipeline

    devs = jax.devices()
    if len(devs) < 2:
        return None
    config = ge._full_config((h, w))

    def run_on(devices):
        mesh = make_mesh(devices)
        pipe = build_pipeline(config, "bayer_gbrg8", frame_hw=(h, w))
        batch = per_dev_batch * len(devices)
        px = jax.device_put(device_noise((batch, h, w), 7),
                            NamedSharding(mesh, P("data", None, None)))
        params = jax.device_put(pipe.params)
        step = _chain_step(pipe)
        spf = steady_per_frame(lambda: step(params, px), batch)
        px.delete()
        return 1.0 / spf

    f1 = run_on(devs[:1])
    fn = run_on(devs)
    eff = fn / (f1 * len(devs))
    log(f"scaling: 1 dev {f1:.1f} fps, {len(devs)} devs {fn:.1f} fps, "
        f"efficiency {eff:.2%}")
    return eff


def main():
    import jax

    from raw_image_pipeline_tpu.utils.compile_cache import (
        enable_compilation_cache,
    )

    enable_compilation_cache()
    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        raise SystemExit(
            f"bench.py needs a GPU; JAX's first device is {d0.platform}"
        )
    head = chain_fps()
    log("per-config (BASELINE.json):")
    config_benchmarks()
    eff = scaling()
    # ratio against the frozen canonical CPU arm (see CANONICAL_CPU_FPS)
    print(json.dumps({
        "metric": "frames_per_sec_per_gpu_1080p_full_isp",
        "value": round(head["fps"], 2),
        "unit": "frames/s",
        "vs_baseline": round(head["fps"] / CANONICAL_CPU_FPS, 2),
        "batch": head["batch"],
        "ms_per_step": round(head["ms_per_step"], 3),
        "scaling_efficiency": None if eff is None else round(eff, 4),
        "device": {"platform": d0.platform, "kind": d0.device_kind,
                   "count": len(devs)},
    }))


if __name__ == "__main__":
    main()
