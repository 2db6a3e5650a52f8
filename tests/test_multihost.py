"""2-process jax.distributed ISP test on the CPU backend.

Keeps the multi-host path honest without pod hardware: two OS processes
initialize a coordinator, form a global device mesh (2 procs x 2 local CPU
devices), each ingests only its LOCAL frame shard via distribute_batch,
and the jitted FULL 9-stage chain (CCC WB + Kalman state + undistortion)
runs on the global array — then every process asserts its addressable
output shards are BITWISE equal to a locally-computed single-process run
of the same batch. Reference runs everything in one process
(raw_image_pipeline_ros.cpp); the multi-host design must be numerically
invisible.
"""

import os
import socket
import subprocess
import sys

import numpy as np

WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.getcwd())
from raw_image_pipeline_tpu.parallel.multihost import (
    initialize_multihost, global_data_mesh, distribute_batch,
)

addr, pid = sys.argv[1], int(sys.argv[2])
initialize_multihost(addr, 2, pid)
assert jax.process_count() == 2, jax.process_count()
assert jax.local_device_count() == 2
assert jax.device_count() == 4, jax.device_count()

mesh = global_data_mesh()
local = np.full((2, 8, 16), 1 + pid, np.int32)  # 2 frames per process
g = distribute_batch(local, mesh)
assert g.shape == (4, 8, 16), g.shape

total = jax.jit(lambda x: jnp.sum(x))(g)
# global sum = (2 frames * 1 + 2 frames * 2) * 8 * 16
expected = (2 * 1 + 2 * 2) * 8 * 16
got = int(jax.device_get(total))
assert got == expected, (got, expected)

# --- the real ISP on the global array ---------------------------------
from jax.sharding import NamedSharding, PartitionSpec as P
import __graft_entry__ as ge
from raw_image_pipeline_tpu.pipeline import build_pipeline, init_state

# production-proportioned frame (matches dryrun_multichip): the CCC
# working resize (360x270) is an actual DOWNSAMPLE and the fisheye remap
# displacements are non-trivial at 272x368
h, w = 272, 368
config = ge._full_config((h, w), for_undistortion=True)
pipe = build_pipeline(config, "bayer_gbrg8", frame_hw=(h, w),
                      with_state=True, temporal_mode="cameras")

# deterministic global batch; each process ingests only its own half
rng = np.random.default_rng(42)
frames_global = rng.integers(0, 256, (4, h, w), np.uint8)
local = frames_global[pid * 2:(pid + 1) * 2]
g = distribute_batch(local, mesh)

state = init_state((4,))
state_shard = jax.tree.map(lambda _: NamedSharding(mesh, P("data")), state)
g_state = jax.tree.map(
    lambda leaf, sh: jax.make_array_from_process_local_data(
        sh, np.asarray(leaf)[pid * 2:(pid + 1) * 2]),
    state, state_shard)

fn = jax.jit(pipe.fn,
             in_shardings=(None, NamedSharding(mesh, P("data")), state_shard))
out, new_state = fn(pipe.params, g, g_state)
jax.block_until_ready((out, new_state))

# single-process reference of the same global batch, computed locally
ref_out, ref_state = pipe.fn(pipe.params, frames_global, init_state((4,)))
ref_img = np.asarray(ref_out["processed"])
ref_x = np.asarray(ref_state.x)
for shard in out["processed"].addressable_shards:
    np.testing.assert_array_equal(np.asarray(shard.data), ref_img[shard.index])
for shard in new_state.x.addressable_shards:
    np.testing.assert_array_equal(np.asarray(shard.data), ref_x[shard.index])
print(f"proc {pid} OK", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_smoke():
    addr = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, addr, str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError("distributed smoke timed out")
        outs.append((p.returncode, out.decode(), err.decode()))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err[-2000:]}"
        assert "OK" in out
