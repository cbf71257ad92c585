"""Runtime configuration.

The reference selects its native layer at compile time via ``cfg(target_arch)``
(src/lib.rs:10-24); here the equivalent switch is the JAX platform: Pallas
kernels compile through Triton on an NVIDIA GPU and run in the Pallas
interpreter on the CPU (how the reference runs its wasm backend under
wasmtime in CI).  Any other backend is refused rather than silently
interpreted.
"""

from __future__ import annotations

import os

import jax

#: Fixed compile-cache path inside the checkout, used only when the
#: environment does not place the cache itself.
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def compile_cache_dir() -> str | None:
    """The directory this package points JAX's persistent compile cache at:
    None when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it itself and
    the code sets nothing), else :data:`REPO_CACHE_DIR`."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return REPO_CACHE_DIR


_cache_dir = compile_cache_dir()
if _cache_dir is not None:
    jax.config.update("jax_compilation_cache_dir", _cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def use_interpret() -> bool:
    """Platform policy for every Pallas kernel: interpret on the CPU (tests),
    compile on the GPU, and refuse anything else."""
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(
        f"sliceslice kernels support the 'gpu' backend (compiled through "
        f"Triton) and 'cpu' (Pallas interpreter); got {backend!r}"
    )
