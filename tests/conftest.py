"""Test harness configuration.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``) with the Pallas
interpreter and an 8-device virtual mesh — the analogue of the reference
executing its wasm backend under wasmtime in CI (check.yml) and of testing
multi-host logic on 1xN meshes (SURVEY.md §4).  Tests marked ``gpu``
compare the compiled kernels with their XLA references on an NVIDIA GPU
(``python -m pytest tests -m gpu`` where the card is, or phase 7 of
``chip_smoke.py``); elsewhere they skip.
"""

import jax
from jax._src import xla_bridge

# A process that already opened its backends (chip_smoke.py running the
# gpu-marked tests in-process) keeps the devices it has.
if not xla_bridge.backends_are_initialized():
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests unless JAX's default backend is a GPU —
    decided when the test runs, never at import or collection."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (compiled Triton kernels)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0x5EED)


@pytest.fixture(scope="session")
def i386_small():
    """First 48 KiB of the conformance corpus — enough to exercise the tiled
    kernel paths quickly under the interpreter."""
    with open("data/i386.txt", "rb") as f:
        return f.read(48 * 1024)


@pytest.fixture(scope="session")
def words():
    with open("data/words.txt", "rb") as f:
        return [w for w in f.read().split(b"\n") if w]
