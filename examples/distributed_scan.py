"""Example: sharded corpus scan over a device mesh.

Runs on every device JAX finds: the GPUs of a machine, or 8 virtual CPU
devices with ``JAX_PLATFORMS=cpu`` (call parallel.distributed.initialize()
first for multi-host):

    python examples/distributed_scan.py
    JAX_PLATFORMS=cpu python examples/distributed_scan.py
"""

import os
import sys

sys.path.insert(0, ".")

import jax

# The device count must be set before any backend-initializing jax call.
if os.environ.get("JAX_PLATFORMS") == "cpu":
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np

import sliceslice_tpu as st
from sliceslice_tpu.parallel import ShardedBatchedSearcher, make_mesh


def main():
    rng = np.random.default_rng(0)
    corpus = bytes(rng.integers(32, 127, (2_000_000,), dtype=np.uint8))
    needles = [corpus[i : i + 8] for i in (0, 999_999, 1_999_990)] + [b"@@@@"]

    n = len(jax.devices())
    mesh = make_mesh((n // 2, 2) if n % 2 == 0 and n > 1 else (n, 1))
    dh = st.preprocess(corpus, kh=16)
    print(f"mesh {dict(zip(mesh.axis_names, mesh.devices.shape))}, "
          f"{dh.g} segments of {dh.seg_bytes:,} bytes")

    sb = ShardedBatchedSearcher(needles, mesh)
    for nd, off in zip(needles, sb.find_all(dh)):
        print(f"  {nd[:12]!r} -> {off}")


if __name__ == "__main__":
    main()
