"""Sharded execution correctness on the 8-device CPU mesh: sharding must
never change numerics, only placement."""

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from raw_image_pipeline_tpu.config import PipelineConfig
from raw_image_pipeline_tpu.parallel.mesh import batch_sharding, make_mesh, shard_batch, spatial_sharding
from raw_image_pipeline_tpu.pipeline import build_pipeline, init_state


def _config():
    cfg = PipelineConfig()
    return PipelineConfig(
        debayer=cfg.debayer,
        white_balance=dataclasses.replace(
            cfg.white_balance, enabled=True, method="grey_world"
        ),
        gamma_correction=dataclasses.replace(cfg.gamma_correction, enabled=True),
        color_enhancer=dataclasses.replace(cfg.color_enhancer, enabled=True,
                                           saturation_gain=1.3),
    )


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (8, 32, 48), np.uint8)


def test_data_parallel_matches_single_device(frames):
    config = _config()
    pipe = build_pipeline(config, "bayer_gbrg8", frame_hw=frames.shape[1:])
    ref, _ = pipe(frames)

    mesh = make_mesh()
    sharded = shard_batch(jax.numpy.asarray(frames), mesh)
    out, _ = pipe(sharded)
    np.testing.assert_array_equal(
        np.asarray(out["processed"]), np.asarray(ref["processed"])
    )


def test_spatial_sharding_matches(frames):
    """Frame split over H across 'space': GSPMD must insert halo exchange
    for the debayer stencil and psums for the WB reductions."""
    config = _config()
    pipe = build_pipeline(config, "bayer_gbrg8", frame_hw=frames.shape[1:])
    ref, _ = pipe(frames)

    mesh = make_mesh(space=4)
    sharded = shard_batch(jax.numpy.asarray(frames), mesh, spatial=True)
    out, _ = pipe(sharded)
    np.testing.assert_array_equal(
        np.asarray(out["processed"]), np.asarray(ref["processed"])
    )


def test_full_chain_spatial_sharding_matches():
    """The FULL 9-stage chain (CCC WB incl. 65k-bin histogram, Kalman
    temporal state, undistortion remap) bit-equal under space=4: the ops
    where GSPMD must insert halo exchanges for the remap gather and psums
    for the histogram are exactly the hard ones — reference computes these
    single-device (convolutional_color_constancy.cpp:237-263,
    modules/white_balance.cpp:89-102)."""
    import __graft_entry__ as ge

    h, w = 112, 96  # H divisible by space*2 (Bayer rows stay phase-aligned)
    config = ge._full_config((h, w), for_undistortion=True)
    pipe = build_pipeline(config, "bayer_gbrg8", frame_hw=(h, w),
                          with_state=True, temporal_mode="cameras")

    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (2, h, w), np.uint8)
    state = init_state((2,))
    ref_out, ref_state = pipe.fn(pipe.params, frames, state)

    mesh = make_mesh(space=4)
    in_shard = NamedSharding(mesh, P("data", "space", None))
    state_shard = jax.tree.map(
        lambda _: NamedSharding(mesh, P("data")), state
    )
    fn = jax.jit(pipe.fn, in_shardings=(None, in_shard, state_shard))
    out, new_state = fn(
        pipe.params,
        jax.device_put(frames, in_shard),
        jax.device_put(state, state_shard),
    )
    np.testing.assert_array_equal(
        np.asarray(out["processed"]), np.asarray(ref_out["processed"])
    )
    np.testing.assert_array_equal(np.asarray(new_state.x), np.asarray(ref_state.x))
    np.testing.assert_array_equal(
        np.asarray(new_state.initialized), np.asarray(ref_state.initialized)
    )


def test_sharding_hint_selects_partitionable_impls():
    """The one program build_pipeline makes partitions under a data x
    space mesh: the sharded outputs equal the unsharded ones bit for bit
    (GSPMD's halo exchanges for the stencils and psums for the CCC
    histogram change placement, never numerics)."""
    import __graft_entry__ as ge

    h, w = 112, 96
    config = ge._full_config((h, w), for_undistortion=True)
    mesh = make_mesh(space=2)
    pipe = build_pipeline(config, "bayer_gbrg8", frame_hw=(h, w))
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (4, h, w), np.uint8)  # divides data=4
    ref, _ = pipe.fn(pipe.params, frames, None)
    for spatial in (False, True):
        sharded = shard_batch(jax.numpy.asarray(frames), mesh, spatial=spatial)
        out, _ = pipe.fn(pipe.params, sharded, None)
        np.testing.assert_array_equal(
            np.asarray(out["processed"]), np.asarray(ref["processed"])
        )


def test_multicamera_mesh_hint():
    """The camera-blocked multicamera program sharded over the data axis
    (cameras x frames) equals its unsharded run."""
    from raw_image_pipeline_tpu.parallel.multicamera import (
        build_multicamera_pipeline,
    )
    import __graft_entry__ as ge

    h, w = 64, 48
    config = ge._full_config((h, w), for_undistortion=False)
    calib = config.calibration
    mesh = make_mesh()
    mc = build_multicamera_pipeline(config, [calib, calib], "bayer_gbrg8",
                                    frame_hw=(h, w))
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (2, 8, h, w), np.uint8)
    ref, _ = mc(frames)
    sharded = jax.device_put(
        frames, NamedSharding(mesh, P(None, "data", None, None))
    )
    out, _ = mc(sharded)
    np.testing.assert_array_equal(
        np.asarray(out["processed"]), np.asarray(ref["processed"])
    )


def test_mesh_shapes():
    mesh = make_mesh(space=2)
    assert mesh.devices.shape == (4, 2)
    assert mesh.axis_names == ("data", "space")
    with pytest.raises(ValueError):
        make_mesh(space=3)


def test_graft_entry_dryrun():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)
