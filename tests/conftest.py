"""Test configuration: run everything on a virtual 8-device CPU mesh.

This is the TPU build's "fake backend" (SURVEY.md §4): distributed tests
exercise real XLA collectives over 8 virtual CPU devices, the same way the
reference's CI uses the custom_cpu plugin (`test/custom_runtime/`).  Bench
runs (bench.py) use the real TPU chip instead.
"""

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: compile-heavy tests excluded from the tier-1 fast run "
        "(`-m 'not slow'`); a plain pytest invocation runs everything")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the paddle_tpu_torch kernels); "
        "skips elsewhere — run on the card with `pytest -m cuda`")


@pytest.fixture(autouse=True)
def _seed_everything():
    import paddle_tpu as paddle
    paddle.seed(2024)
    np.random.seed(2024)
    yield


@pytest.fixture()
def hybrid_mesh():
    """dp2 x mp2 x sharding2 hybrid topology over the 8-device CPU mesh."""
    from paddle_tpu.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2,
                               "pp_degree": 1, "sharding_degree": 2,
                               "sep_degree": 1}
    yield fleet.init(is_collective=True, strategy=strategy)
