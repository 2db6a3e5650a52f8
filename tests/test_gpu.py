"""Card-only tests: the chain on the GPU against the same chain on XLA:CPU
(chip_smoke.py's phases at small sizes). They skip without a GPU; run them
on one with

    RIP_TEST_PLATFORM=gpu python -m pytest tests/test_gpu.py -m gpu
"""

import jax
import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu


def test_streamed_chain_matches_cpu(gpu):
    cs.phase_stream(jax.devices("cpu")[0], 3, hw=(272, 368), n_frames=4)


def test_throughput_chain_and_numerics_match_cpu(gpu):
    cpu = jax.devices("cpu")[0]
    frames, config = cs.phase_throughput(cpu, 4, batch=4, hw=(272, 368),
                                         steps=1)
    cs.phase_numerics(cpu, frames, config, slab=16, sweep_first=16)
