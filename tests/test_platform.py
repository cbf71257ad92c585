"""Platform policy: which kernels run where, where the compile cache lives,
and which published peaks the benchmarks divide by."""

import jax
import pytest

from sliceslice_tpu import config
from sliceslice_tpu.utils.profiling import (
    PEAK_MEMORY_BYTES_PER_S,
    peak_memory_bandwidth,
)


@pytest.mark.parametrize(
    "backend, interpret", [("cpu", True), ("gpu", False)]
)
def test_use_interpret_policy(monkeypatch, backend, interpret):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert config.use_interpret() is interpret


@pytest.mark.parametrize("backend", ["rocm", "METAL", "neuron"])
def test_use_interpret_refuses_other_backends(monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    with pytest.raises(RuntimeError, match="gpu"):
        config.use_interpret()


def test_pairwise_follows_policy(monkeypatch):
    from sliceslice_tpu.ops.pairwise import PairwiseSearcher

    assert PairwiseSearcher([b"ab"]).use_pallas
    monkeypatch.setattr(jax, "default_backend", lambda: "neuron")
    with pytest.raises(RuntimeError):
        PairwiseSearcher([b"ab"])


def test_cache_dir_from_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.compile_cache_dir() is None


def test_cache_dir_fixed_in_checkout(monkeypatch):
    import os

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = config.compile_cache_dir()
    assert path == config.REPO_CACHE_DIR
    repo = os.path.dirname(os.path.dirname(os.path.abspath(config.__file__)))
    assert os.path.dirname(path) == repo


def test_peak_table_known_kind():
    assert peak_memory_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    assert all(v > 0 for v in PEAK_MEMORY_BYTES_PER_S.values())


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_peak_table_unknown_kind_raises(kind):
    with pytest.raises(KeyError, match="no published memory peak"):
        peak_memory_bandwidth(kind)
