"""Smoke run of the ISP chain on one GPU, checked against the same chain on
XLA:CPU in the same process.

    python chip_smoke.py                  # one GPU: phases 1-5
    python chip_smoke.py --four-cards     # four GPUs: the sharded chain only
    python chip_smoke.py --trace DIR      # also trace the 1080p B=64 step

Phases (one GPU):
  1. device: fail unless JAX's first device is a GPU; print its kind, the
     nvidia-smi name and power limit, XLA_FLAGS and the compile cache;
  2. reference API: RawImagePipeline with the launch-file profile, the
     1.6 MP calibration and the color calibration, .process() on a few
     1440x1080 bayer_gbrg8 frames;
  3. throughput path: build_pipeline on the full 9-stage 1080p chain at
     B=64 — memory_analysis(), a few timed steps, peak device memory;
  4. streamed state: temporal_mode="sequence" over 8 frames in two
     dispatches, outputs and the carried Kalman state;
  5. numerics the card can change: the CCC histogram and the response
     argmax at DEFAULT (TF32) vs HIGHEST precision on 64 frame histograms,
     the color-calibration chain over all 2^24 u8 triples, and exhaustive
     lab_to_bgr / hsv_to_bgr / bgr_to_lab sweeps.

The plain reference for every phase is the same chain built and run under
jax.default_device(cpu): the tier-1 tests pin that chain bit-exact to the
cv2 goldens. Every u8 output must be within 1 LSB of it (the target is 0
mismatching pixels) and every CCC illuminant bin must match. Frames are
synthetic scenes made from --seed.

Any failed phase exits non-zero. The last line of stdout is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

MAX_LSB = 1  # BASELINE's bound for any u8 output vs the reference
CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")


class SmokeFailure(AssertionError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def compare_u8(name: str, got, want, max_lsb: int = MAX_LSB) -> tuple:
    """Print the mismatch count and max |difference| of one output against
    its reference; raise SmokeFailure beyond max_lsb. Returns (n, max)."""
    got = np.asarray(got)
    want = np.asarray(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise SmokeFailure(
            f"{name}: {got.shape} {got.dtype} vs reference "
            f"{want.shape} {want.dtype}"
        )
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    n = int(np.count_nonzero(diff))
    mx = int(diff.max()) if diff.size else 0
    log(f"  {name}: {n} of {diff.size} values differ, max |diff| {mx}")
    if mx > max_lsb:
        raise SmokeFailure(f"{name}: max |diff| {mx} > {max_lsb} LSB")
    return n, mx


def compare_bins(name: str, got, want) -> int:
    """CCC illuminant bins ([..., 2] int): every one must match."""
    got = np.asarray(got)
    want = np.asarray(want)
    n = int(np.count_nonzero((got != want).any(axis=-1)))
    log(f"  {name}: {n} of {got.shape[0]} frames differ")
    if n:
        raise SmokeFailure(f"{name}: {n} frames pick another illuminant bin")
    return n


def compare_state(name: str, got, want) -> None:
    """Kalman state: `initialized` and the truncated track (what drives
    the gains) must match; the float differences are printed."""
    gx, wx = np.asarray(got.x), np.asarray(want.x)
    dx = float(np.abs(gx - wx).max()) if gx.size else 0.0
    dp = float(np.abs(np.asarray(got.p) - np.asarray(want.p)).max())
    log(f"  {name}: max |dx| {dx!r}, max |dp| {dp!r}")
    if not np.array_equal(np.asarray(got.initialized),
                          np.asarray(want.initialized)):
        raise SmokeFailure(f"{name}: initialized differs")
    if not np.array_equal(np.trunc(gx), np.trunc(wx)):
        raise SmokeFailure(f"{name}: the truncated illuminant track differs")


def synth_bayer(seed: int, n: int, h: int, w: int) -> np.ndarray:
    """[n, h, w] u8 bayer_gbrg8 mosaics of smooth random color scenes under
    a random per-frame illuminant, with sensor-like noise (so the CCC
    histogram is a real scene histogram, not uniform noise). Made on the
    default device in one dispatch and returned on the host."""
    import jax
    import jax.numpy as jnp

    def make(key):
        k1, k2, k3 = jax.random.split(key, 3)
        scene = jax.random.uniform(k1, (n, 9, 16, 3), minval=0.05,
                                   maxval=0.95)
        illum = jax.random.uniform(k2, (n, 1, 1, 3), minval=0.45,
                                   maxval=1.0)
        img = jax.image.resize(scene * illum, (n, h, w, 3), "linear")
        img = img + 0.03 * jax.random.normal(k3, (n, h, w, 3))
        bgr = jnp.clip(jnp.rint(img * 255.0), 0, 255).astype(jnp.uint8)
        # gbrg: (0,0)=G (0,1)=B (1,0)=R (1,1)=G, channels in BGR order
        bay = bgr[..., 1]
        bay = bay.at[:, 0::2, 1::2].set(bgr[:, 0::2, 1::2, 0])
        bay = bay.at[:, 1::2, 0::2].set(bgr[:, 1::2, 0::2, 2])
        return bay

    return np.asarray(jax.jit(make)(jax.random.PRNGKey(seed)))


def ccc_bins(params, bgr):
    """Per-frame CCC illuminant bin (argmax of the response at the chain's
    precision) of [B, H, W, 3] u8 frames, with the pipeline's own CCC
    parameters."""
    import jax

    from raw_image_pipeline_tpu.ops import ccc

    @jax.jit
    def run(p, img):
        small = ccc.resize_linear_u8(img, ccc.SMALL_H, ccc.SMALL_W)
        hist = ccc.log_chroma_histogram_rt(
            small, p.ccc_gray_hi, p.ccc_gray_lo, p.ccc_uv0
        )
        resp = ccc.ccc_response(
            hist, p.ccc_filt_dft_re, p.ccc_filt_dft_im, p.ccc_bias
        )
        return ccc.response_argmax(resp)

    return np.asarray(run(params, bgr))


def report_stage_times(trace_dir: str, hlo_text: str, steps: int) -> None:
    """Per-stage device time per step from the trace, for every GPU line
    of the trace; the 25 longest instructions per line go to
    <trace_dir>/stage_times.json and the step's HLO to step.hlo.txt."""
    import glob

    from raw_image_pipeline_tpu.utils.profiling import (
        device_kernel_events,
        hlo_stage_scopes,
        stage_device_times,
    )

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True))
    if not paths:
        raise SmokeFailure(f"no .xplane.pb under {trace_dir}")
    scopes = hlo_stage_scopes(hlo_text)
    summary = {}
    for line, events in device_kernel_events(paths[-1]).items():
        per_stage = stage_device_times(events, scopes)
        total = sum(per_stage.values())
        log(f"  {line}: {len(events)} events, {total / steps / 1e6:.3f} "
            "ms/step: " + ", ".join(
                f"{k} {v / steps / 1e6:.3f}" for k, v in
                sorted(per_stage.items(), key=lambda kv: -kv[1])))
        by_name = {}
        for name, dur in events:
            by_name[name] = by_name.get(name, 0) + dur
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:25]
        summary[line] = {
            "ms_per_step": {k: v / steps / 1e6 for k, v in per_stage.items()},
            "top": [(n, scopes.get(n, "other"), d / steps / 1e6)
                    for n, d in top],
        }
    with open(os.path.join(trace_dir, "stage_times.json"), "w") as f:
        json.dump(summary, f, indent=1)
    with open(os.path.join(trace_dir, "step.hlo.txt"), "w") as f:
        f.write(hlo_text)


def nvidia_smi() -> str:
    """The card's name and power limit, read without JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    import jax

    from raw_image_pipeline_tpu.utils.compile_cache import (
        enable_compilation_cache,
    )

    cache = enable_compilation_cache()
    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        raise SmokeFailure(
            f"no GPU: JAX's first device is {d0.platform} ({d0.device_kind})"
        )
    log("phase 1: device")
    log(f"  jax {jax.__version__}, {len(devs)} x {d0.device_kind} "
        f"({d0.platform})")
    log(f"  nvidia-smi: {nvidia_smi()}")
    log(f"  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"  compile cache: {cache}")
    return devs


def phase_reference_api(cpu, seed: int, n_frames: int = 3,
                        params_name="alphasense_launch_profile.yaml",
                        calibration_name="alphasense_calib_1.6mp_example.yaml",
                        color_name="alphasense_color_calib_example.yaml"):
    """RawImagePipeline.process() frame by frame on the default device and
    on the CPU; processed, debayered and dist_color compared per frame."""
    import jax

    from raw_image_pipeline_tpu import RawImagePipeline
    from raw_image_pipeline_tpu.config import load_camera_calibration

    log("phase 2: reference API, native deployment")
    params_path = os.path.join(CONFIGS, params_name)
    calibration_path = os.path.join(CONFIGS, calibration_name)
    color_path = os.path.join(CONFIGS, color_name)
    calib = load_camera_calibration(calibration_path)
    h, w = calib.image_height, calib.image_width
    frames = synth_bayer(seed, n_frames, h, w)

    def run(device):
        with jax.default_device(device):
            api = RawImagePipeline(
                use_gpu=False, params_path=params_path,
                calibration_path=calibration_path,
                color_calibration_path=color_path,
            )
            outs = []
            for f in frames:
                api.process(f, "bayer_gbrg8")
                outs.append({
                    "processed": api.get_processed_image(),
                    "debayered": api.get_dist_debayered_image(),
                    "dist_color": api.get_dist_color_image(),
                })
            return outs

    t0 = time.perf_counter()
    got = run(jax.devices()[0])
    t1 = time.perf_counter()
    want = run(cpu)
    log(f"  {n_frames} frames {w}x{h}: device {t1 - t0:.1f} s, cpu "
        f"{time.perf_counter() - t1:.1f} s (compiles included)")
    for i, (g, r) in enumerate(zip(got, want)):
        for k in ("processed", "debayered", "dist_color"):
            compare_u8(f"frame {i} {k}", g[k], r[k])


def phase_throughput(cpu, seed: int, batch: int = 64, hw=(1080, 1920),
                     steps: int = 5, trace_dir=None):
    """The full 9-stage chain at `batch`: compile, memory_analysis, timed
    steps, peak memory; processed compared with the CPU run of the same
    frames. Returns the host frames and the config for phase 5."""
    import jax

    import __graft_entry__ as ge
    from raw_image_pipeline_tpu.pipeline import build_pipeline

    log(f"phase 3: throughput path, {hw[1]}x{hw[0]} B={batch}")
    config = ge._full_config(hw)
    dev = jax.devices()[0]
    frames = synth_bayer(seed + 1, batch, *hw)
    pipe = build_pipeline(config, "bayer_gbrg8", frame_hw=hw)
    px = jax.device_put(frames, dev)
    t0 = time.perf_counter()
    compiled = pipe.fn.lower(pipe.params, px, None).compile()
    log(f"  compile {time.perf_counter() - t0:.1f} s")
    log(f"  memory_analysis: {compiled.memory_analysis()}")
    out, _ = compiled(pipe.params, px, None)
    jax.block_until_ready(out)
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        out, _ = compiled(pipe.params, px, None)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    stats = dev.memory_stats() or {}
    log(f"  wall per step on {dev.device_kind}: "
        + ", ".join(f"{t * 1e3:.2f}" for t in times)
        + f" ms (informational); peak_bytes_in_use "
        f"{stats.get('peak_bytes_in_use')}")
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        with jax.profiler.trace(trace_dir):
            for _ in range(3):
                out, _ = compiled(pipe.params, px, None)
            jax.block_until_ready(out)
        log(f"  trace of 3 steps written to {trace_dir}")
        report_stage_times(trace_dir, compiled.as_text(), steps=3)
    got = np.asarray(out["processed"])
    del out, px

    with jax.default_device(cpu):
        t0 = time.perf_counter()
        ref_pipe = build_pipeline(config, "bayer_gbrg8", frame_hw=hw)
        ref, _ = ref_pipe(frames, None)
        ref = np.asarray(ref["processed"])
        log(f"  cpu reference: {time.perf_counter() - t0:.1f} s")
    compare_u8(f"B={batch} processed", got, ref)
    return frames, config


def phase_stream(cpu, seed: int, hw=(1080, 1920), n_frames: int = 8,
                 dispatches: int = 2):
    """temporal_mode="sequence" with the carried Kalman track, n_frames in
    `dispatches` calls; outputs, per-frame illuminant bins and the final
    state compared with the CPU run."""
    import jax

    import __graft_entry__ as ge
    from raw_image_pipeline_tpu.pipeline import build_pipeline, init_state

    log(f"phase 4: streamed state, {n_frames} sequential frames in "
        f"{dispatches} dispatches")
    config = ge._full_config(hw)
    frames = synth_bayer(seed + 2, n_frames, *hw)
    chunks = np.split(frames, dispatches)

    def run(device):
        with jax.default_device(device):
            pipe = build_pipeline(config, "bayer_gbrg8", frame_hw=hw,
                                  with_state=True, temporal_mode="sequence",
                                  keep_intermediates=True)
            state = init_state(())
            outs = []
            for c in chunks:
                o, state = pipe(c, state)
                outs.append({k: np.asarray(v) for k, v in o.items()})
            outs = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
            uv = ccc_bins(pipe.params, outs["debayered"])
            state = jax.tree.map(np.asarray, state)
            return outs, uv, state

    got, got_uv, got_state = run(jax.devices()[0])
    want, want_uv, want_state = run(cpu)
    for k in ("processed", "debayered", "dist_color"):
        compare_u8(k, got[k], want[k])
    compare_bins("CCC illuminant bins (per-frame argmax)", got_uv, want_uv)
    compare_state("Kalman state", got_state, want_state)


def phase_numerics(cpu, frames: np.ndarray, config, slab: int = 64,
                   sweep_first: int = 256):
    """CCC histogram + response precision, color calibration and the
    exhaustive colorspace sweeps, each on the default device vs the CPU.
    The sweeps and the color-calibration check cover sweep_first values
    of the first channel (256: all 2^24 inputs), `slab` per dispatch."""
    import jax
    import jax.numpy as jnp

    from raw_image_pipeline_tpu.ops import ccc
    from raw_image_pipeline_tpu.ops import colorspace as cs
    from raw_image_pipeline_tpu.ops.color_calibration import (
        color_correct_planes,
    )
    from raw_image_pipeline_tpu.ops.debayer import debayer
    from raw_image_pipeline_tpu.pipeline import make_params

    log(f"phase 5: numerics ({frames.shape[0]} frame histograms, sweeps)")
    dev = jax.devices()[0]

    # CCC, stage by stage on the phase-3 frames: working resize, per-pixel
    # bins and valid mask, histogram, response argmax at DEFAULT (TF32 on
    # the GPU) and HIGHEST precision — each vs the CPU
    def ccc_stages(device):
        with jax.default_device(device):
            p = make_params(config, frames.shape[1:])
            bgr = debayer(jnp.asarray(frames), "bayer_gbrg8")
            small = ccc.resize_linear_u8(bgr, ccc.SMALL_H, ccc.SMALL_W)
            cuts = (p.ccc_gray_hi, p.ccc_gray_lo, p.ccc_uv0)
            u, v, valid = jax.jit(ccc.log_chroma_bins)(small, *cuts)
            hist = ccc.log_chroma_histogram_rt(small, *cuts)
            out = {"small": small, "u": u, "v": v, "valid": valid,
                   "hist": hist}
            for name, prec in (("DEFAULT", None),
                               ("HIGHEST", jax.lax.Precision.HIGHEST)):
                resp = ccc.ccc_response(
                    hist, p.ccc_filt_dft_re, p.ccc_filt_dft_im, p.ccc_bias,
                    precision=prec,
                )
                out[name] = ccc.response_argmax(resp)
            return {k: np.asarray(x) for k, x in out.items()}

    g, c = ccc_stages(dev), ccc_stages(cpu)
    compare_u8("CCC working resize", g["small"], c["small"], max_lsb=0)
    # per-pixel and histogram differences are reported; what the chain
    # consumes is the argmax
    for k in ("u", "v", "valid", "hist"):
        log(f"  CCC {k}: {int(np.count_nonzero(g[k] != c[k]))} of "
            f"{g[k].size} differ from the cpu")
    compare_bins("CCC argmax DEFAULT vs HIGHEST (device)",
                 g["DEFAULT"], g["HIGHEST"])
    compare_bins("CCC argmax DEFAULT (device) vs cpu",
                 g["DEFAULT"], c["HIGHEST"])

    # the same per-pixel bins and mask for every u8 triple
    def bins(device):
        with jax.default_device(device):
            p = make_params(config, frames.shape[1:])
            i = jnp.arange(sweep_first * 256 * 256, dtype=jnp.int32)
            img = jnp.stack([(i >> 16) & 0xFF, (i >> 8) & 0xFF, i & 0xFF],
                            -1).astype(jnp.uint8)
            u, v, valid = jax.jit(ccc.log_chroma_bins)(
                img, p.ccc_gray_hi, p.ccc_gray_lo, p.ccc_uv0)
            return np.asarray(u), np.asarray(v), np.asarray(valid)

    for name, gb, cb in zip(("u", "v", "valid"), bins(dev), bins(cpu)):
        log(f"  CCC per-pixel {name} over {sweep_first}x2^16 triples: "
            f"{int(np.count_nonzero(gb != cb))} differ from the cpu")

    # color calibration: the sealed plain two-rounding chain (cv::gemm
    # semantics) over every u8 triple, on the device and on the CPU, each
    # vs a host oracle that rounds every f32 op of the plain chain once
    # (exact f64 op, then to f32)
    m = np.array([[1.8, -0.3, 0.1], [0.09, 1.2, -0.1], [-0.24, -0.22, 2.1]],
                 np.float32)
    bias = np.array([1.5, -2.0, 3.0], np.float32)
    i = np.arange(sweep_first * 256 * 256, dtype=np.int64)
    bgr = [((i >> sh) & 0xFF).astype(np.uint8) for sh in (16, 8, 0)]

    def oracle():
        f32, f64 = np.float32, np.float64
        x = [ch.astype(f64) for ch in bgr]
        out = []
        for o in range(3):
            p = [(x[k] * f64(m[o, k])).astype(f32).astype(f64)
                 for k in range(3)]
            s_ = ((p[0] + p[1]).astype(f32).astype(f64) + p[2]).astype(f32)
            out.append(np.clip(np.rint(s_ + bias[o]), 0, 255)
                       .astype(np.uint8))
        return np.stack(out)

    def colorcal(device):
        # matrix and bias are ARGUMENTS: the chain's seal needs a runtime
        # zero the compiler cannot fold (ops/common.seal_f32)
        with jax.default_device(device):
            run = jax.jit(lambda mj, bj, b, g, r: jnp.stack(
                color_correct_planes(b, g, r, mj, bj)))
            return np.asarray(run(m, bias, *bgr))

    want = oracle()
    g_cc, c_cc = colorcal(dev), colorcal(cpu)
    compare_u8(f"colorcal {sweep_first}x2^16 (device vs cpu)", g_cc, c_cc,
               max_lsb=0)
    compare_u8(f"colorcal {sweep_first}x2^16 (device vs plain-chain oracle)",
               g_cc, want, max_lsb=0)

    # exhaustive colorspace sweeps: all 2^24 inputs in slabs
    slab = min(slab, sweep_first)
    aa, bb = np.meshgrid(np.arange(256, dtype=np.uint8),
                         np.arange(256, dtype=np.uint8), indexing="ij")
    for name, fn in (("lab_to_bgr", cs.lab_to_bgr_u8),
                     ("hsv_to_bgr", cs.hsv_to_bgr_u8),
                     ("bgr_to_lab", cs.bgr_to_lab_u8)):
        results = {}
        for label, device in (("device", dev), ("cpu", cpu)):
            with jax.default_device(device):
                f = jax.jit(fn)
                parts = []
                for x0 in range(0, sweep_first, slab):
                    xs = np.arange(x0, x0 + slab, dtype=np.uint8)
                    img = np.stack([
                        np.broadcast_to(xs[:, None, None], (slab, 256, 256)),
                        np.broadcast_to(aa, (slab, 256, 256)),
                        np.broadcast_to(bb, (slab, 256, 256)),
                    ], -1).reshape(slab, -1, 3)
                    parts.append(np.asarray(f(img)))
                results[label] = np.concatenate(parts)
        compare_u8(f"{name} {sweep_first}x2^16", results["device"],
                   results["cpu"], max_lsb=0)


def phase_four_cards(seed: int, hw=(1080, 1920), per_card: int = 64):
    """The full chain sharded over four GPUs (data=4, and data=2 x
    space=2); outputs and the Kalman state must be bitwise equal to the
    one-card run of the same frames, made in per-card chunks (state
    carried through the chunks in order)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import __graft_entry__ as ge
    from raw_image_pipeline_tpu.parallel.mesh import make_mesh
    from raw_image_pipeline_tpu.pipeline import build_pipeline, init_state

    devs = jax.devices()
    if len(devs) < 4:
        raise SmokeFailure(f"--four-cards needs 4 devices, found {len(devs)}")
    devs = devs[:4]
    config = ge._full_config(hw)
    for space, mode in ((1, "sequence"), (2, "cameras")):
        mesh = make_mesh(devs, space=space)
        data = 4 // space
        batch = data * per_card
        log(f"four cards: data={data} space={space} temporal_mode={mode}, "
            f"{batch} frames {hw[1]}x{hw[0]}")
        frames = synth_bayer(seed + 10 + space, batch, *hw)
        pipe = build_pipeline(config, "bayer_gbrg8", frame_hw=hw,
                              with_state=True, temporal_mode=mode)
        st_shape = (batch,) if mode == "cameras" else ()
        st_spec = P("data") if mode == "cameras" else P()
        in_shard = NamedSharding(mesh, P("data", "space", None))
        st_shard = jax.tree.map(lambda _: NamedSharding(mesh, st_spec),
                                init_state(st_shape))
        fn = jax.jit(pipe.fn, in_shardings=(None, in_shard, st_shard))
        t0 = time.perf_counter()
        out, state = fn(pipe.params, jax.device_put(frames, in_shard),
                        jax.device_put(init_state(st_shape), st_shard))
        got = np.asarray(out["processed"])
        got_state = jax.tree.map(np.asarray, state)
        del out, state
        log(f"  sharded run {time.perf_counter() - t0:.1f} s "
            "(compile included)")

        # one-card reference in per-card chunks
        ref, ref_states = [], []
        state = init_state(() if mode == "sequence" else (per_card,))
        for i in range(data):
            chunk = frames[i * per_card:(i + 1) * per_card]
            if mode == "cameras":
                state = init_state((per_card,))
            o, state = pipe(jax.device_put(chunk, devs[0]), state)
            ref.append(np.asarray(o["processed"]))
            ref_states.append(jax.tree.map(np.asarray, state))
        ref = np.concatenate(ref)
        if mode == "cameras":
            ref_state = jax.tree.map(lambda *xs: np.concatenate(xs),
                                     *ref_states)
        else:
            ref_state = ref_states[-1]
        compare_u8("processed (sharded vs one card)", got, ref, max_lsb=0)
        for f in ("x", "p", "initialized"):
            a = getattr(got_state, f)
            b = getattr(ref_state, f)
            if not np.array_equal(a, b):
                raise SmokeFailure(f"Kalman state {f} differs across cards")
        log("  Kalman state: bitwise equal")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU sharded phase")
    ap.add_argument("--trace", metavar="DIR",
                    help="write a jax.profiler trace of the 1080p B=64 step")
    args = ap.parse_args(argv)
    if args.trace:
        # one kernel per trace event: with CUDA command buffers a whole step
        # shows as a single event and no stage can be told apart
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_gpu_enable_command_buffer="
        ).strip()

    import jax

    devs = phase_device()
    if args.four_cards:
        phase_four_cards(args.seed)
    else:
        cpu = jax.devices("cpu")[0]
        phase_reference_api(cpu, args.seed)
        frames, config = phase_throughput(cpu, args.seed,
                                          trace_dir=args.trace)
        phase_stream(cpu, args.seed)
        phase_numerics(cpu, frames, config)
    log(f"card: {nvidia_smi()}")
    d0 = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind, "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    # keep the CPU backend reachable beside the GPU for the reference runs
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    sys.exit(main())
