# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# real single CPU device; only launch/dryrun.py forces 512 placeholder devices.
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and nvcc (the port's Hopper "
        "kernels); skips elsewhere")
