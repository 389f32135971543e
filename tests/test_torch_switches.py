"""The environment switches of the port's crypto plane against the
reference's, on the CPU.

- ``HOTSTUFF_CRYPTO_BACKEND``: under the same value both packages'
  ``get_backend()`` build the same kind of backend (``cpu`` a serial
  ``CpuBackend``, ``cpu-batched`` one behind ``BatchingBackend``). Unset,
  the port's default stays ``cuda``, which raises without a card; ``tpu``
  (the reference's name) and any other unknown value raise ``ValueError``
  in the port.
- ``HOTSTUFF_TPU_CACHE``: ``0``, ``false`` or ``no`` gives an uncached
  ``CudaBackend``, as in the reference's ``TpuBackend``; an explicit
  ``cache=`` argument wins over the variable.
- ``HOTSTUFF_TPU_SHARDED``: under the same value both backends build a mesh
  of the same size or none. The reference's ``TpuBackend`` sees the
  conftest's 8 virtual CPU devices; the port's ``visible_devices`` is
  patched to 8 ``cpu`` entries. An explicit ``sharded=`` argument wins.
"""

import pytest
import torch

import hotstuff_tpu.crypto as j_crypto
import hotstuff_tpu.crypto.batching as j_batching
import hotstuff_tpu_torch.crypto as t_crypto
import hotstuff_tpu_torch.crypto.batching as t_batching
from hotstuff_tpu_torch.crypto.cuda_backend import CudaBackend
from hotstuff_tpu_torch.parallel import mesh as pm


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    monkeypatch.setattr(t_crypto, "_BACKEND", None)
    monkeypatch.setattr(j_crypto, "_BACKEND", None)
    monkeypatch.delenv("HOTSTUFF_CRYPTO_BACKEND", raising=False)
    monkeypatch.delenv("HOTSTUFF_TPU_CACHE", raising=False)
    monkeypatch.delenv("HOTSTUFF_TPU_SHARDED", raising=False)


def kind(backend, batching_cls, cpu_cls) -> str:
    if isinstance(backend, batching_cls):
        return "batched " + kind(backend.inner, batching_cls, cpu_cls)
    return "cpu" if isinstance(backend, cpu_cls) else type(backend).__name__


@pytest.mark.parametrize("value", ["cpu", "cpu-batched"])
def test_same_value_same_backend_in_both_packages(monkeypatch, value):
    monkeypatch.setenv("HOTSTUFF_CRYPTO_BACKEND", value)
    port = t_crypto.get_backend()
    reference = j_crypto.get_backend()
    got = kind(port, t_batching.BatchingBackend, t_crypto.CpuBackend)
    want = kind(reference, j_batching.BatchingBackend, j_crypto.CpuBackend)
    assert got == want == {"cpu": "cpu", "cpu-batched": "batched cpu"}[value]
    assert t_crypto.get_backend() is port  # chosen once, at first use


@pytest.mark.parametrize("value", [None, "cuda", "cuda-batched"])
def test_the_card_backends_raise_without_a_card(monkeypatch, value):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if value is not None:
        monkeypatch.setenv("HOTSTUFF_CRYPTO_BACKEND", value)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_crypto.get_backend()
    assert t_crypto._BACKEND is None


@pytest.mark.parametrize("value", ["tpu", "tpu-batched", "gpu", "cpu-fused", ""])
def test_unknown_values_raise_value_error(monkeypatch, value):
    monkeypatch.setenv("HOTSTUFF_CRYPTO_BACKEND", value)
    with pytest.raises(ValueError):
        t_crypto.get_backend()
    assert t_crypto._BACKEND is None


@pytest.mark.parametrize("value, cached", [("0", False), ("false", False), ("no", False),
                                           ("1", True), ("yes", True), (None, True)])
def test_tpu_cache_switch(monkeypatch, value, cached):
    if value is not None:
        monkeypatch.setenv("HOTSTUFF_TPU_CACHE", value)
    assert (CudaBackend(device="cpu")._cache is not None) is cached


def test_explicit_cache_argument_wins(monkeypatch):
    monkeypatch.setenv("HOTSTUFF_TPU_CACHE", "0")
    assert CudaBackend(device="cpu", cache=True)._cache is not None
    monkeypatch.setenv("HOTSTUFF_TPU_CACHE", "1")
    assert CudaBackend(device="cpu", cache=False)._cache is None


@pytest.fixture
def eight_devices(monkeypatch):
    """Both packages see 8 devices; neither builds a point cache."""
    monkeypatch.setenv("HOTSTUFF_TPU_CACHE", "0")
    monkeypatch.setattr(pm, "visible_devices",
                        lambda device_type="cuda": [torch.device(device_type)] * 8)


def mesh_sizes(**kwargs):
    from hotstuff_tpu.crypto.tpu_backend import TpuBackend

    reference = TpuBackend(**kwargs)._mesh
    port = CudaBackend(device="cpu", **kwargs)._mesh
    return (None if reference is None else int(reference.devices.size),
            None if port is None else port.size)


@pytest.mark.parametrize("value, size", [(None, 8), ("auto", 8), ("0", None), ("false", None),
                                         ("no", None), ("1", 8), ("yes", 8), ("true", 8)])
def test_tpu_sharded_switch(monkeypatch, eight_devices, value, size):
    if value is not None:
        monkeypatch.setenv("HOTSTUFF_TPU_SHARDED", value)
    assert mesh_sizes() == (size, size)


@pytest.mark.parametrize("value, sharded", [("0", True), ("1", False)])
def test_explicit_sharded_argument_wins(monkeypatch, eight_devices, value, sharded):
    monkeypatch.setenv("HOTSTUFF_TPU_SHARDED", value)
    size = 8 if sharded else None
    assert mesh_sizes(sharded=sharded) == (size, size)
