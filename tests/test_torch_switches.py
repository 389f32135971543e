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

And the telemetry plane's, against ``hotstuff_tpu.telemetry``: under the
same values of ``HOTSTUFF_TELEMETRY``, ``HOTSTUFF_TELEMETRY_DIR``,
``HOTSTUFF_TELEMETRY_INTERVAL``, ``HOTSTUFF_DTRACE``, ``HOTSTUFF_FLIGHT_DIR``,
``HOTSTUFF_FLIGHT_CAPACITY``, ``HOTSTUFF_PYPROF_INTERVAL_MS`` and
``HOTSTUFF_TRACEMALLOC`` both packages enable the same planes and name the
same paths, periods and capacities. ``HOTSTUFF_PYPROF`` (read by the node)
is held in ``tests/test_torch_telemetry.py``.

And faultline's: ``HOTSTUFF_FAULTLINE_NODE`` gives both packages'
``faultline.hooks.NODE`` the same default (read at import, so in a fresh
interpreter), and ``HOTSTUFF_FAULTLINE`` arms both nodes' planes alike
(unset: no plane; a scenario path: the same schedule and address map).

And the transport's: ``HOTSTUFF_NET=native`` swaps both packages'
``Receiver``, ``SimpleSender`` and ``ReliableSender`` for their native
classes (unset or another value: asyncio), and ``HOTSTUFF_CMD_RING=0``
turns both native transports' command ring off (unset: on); both are read
at import or construction, so each case runs in a fresh interpreter. One
departure is held: with ``HOTSTUFF_NET=native``, a native library that
cannot be built or loaded makes the port's ``network`` import raise, where
the reference logs a warning and keeps asyncio.

And the engine groups': ``HOTSTUFF_ENGINE_GROUPS`` gives both packages'
``groups_from_env`` the same count (unset, junk or negative: 0, one
process).
"""

import pytest
import torch

import hotstuff_tpu.crypto as j_crypto
import hotstuff_tpu.crypto.batching as j_batching
import hotstuff_tpu.telemetry as j_tm
import hotstuff_tpu_torch.telemetry as t_tm
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


TELEMETRY_SWITCHES = (
    "HOTSTUFF_TELEMETRY", "HOTSTUFF_TELEMETRY_DIR", "HOTSTUFF_TELEMETRY_INTERVAL",
    "HOTSTUFF_DTRACE", "HOTSTUFF_FLIGHT_DIR", "HOTSTUFF_FLIGHT_CAPACITY",
    "HOTSTUFF_PYPROF_INTERVAL_MS", "HOTSTUFF_TRACEMALLOC",
)


@pytest.fixture
def telemetry_env(monkeypatch):
    for name in TELEMETRY_SWITCHES:
        monkeypatch.delenv(name, raising=False)

    def apply(**values):
        for name, value in values.items():
            monkeypatch.setenv(name, value)
        for tm in (t_tm, j_tm):
            tm.reset_for_tests()

    yield apply
    for name in TELEMETRY_SWITCHES:
        monkeypatch.delenv(name, raising=False)
    for tm in (t_tm, j_tm):
        tm.reset_for_tests()


def telemetry_view(tm, node: str) -> dict:
    """What a package makes of the environment: planes, paths, periods."""
    from importlib import import_module

    trace = import_module(tm.__name__ + ".trace")
    profiler = import_module(tm.__name__ + ".profiler")
    enabled = tm.enabled()
    tm.enable()
    return {
        "enabled": enabled, "dtrace": tm.dtrace_enabled(),
        "stream": tm.env_stream_path(node), "flight": tm.env_flight_path(node),
        "interval_s": tm.env_interval_s(), "flight_capacity": trace.TraceBuffer().capacity,
        "pyprof_interval_ms": profiler.env_interval_ms(),
    }


@pytest.mark.parametrize("values", [
    {},
    {"HOTSTUFF_TELEMETRY": "/data/t.jsonl"},
    {"HOTSTUFF_TELEMETRY_DIR": "/data/run", "HOTSTUFF_TELEMETRY_INTERVAL": "0.5"},
    {"HOTSTUFF_TELEMETRY": "/data/t.jsonl", "HOTSTUFF_TELEMETRY_DIR": "/data/run"},
    {"HOTSTUFF_TELEMETRY_DIR": "/data/run", "HOTSTUFF_DTRACE": "0",
     "HOTSTUFF_FLIGHT_DIR": "/data/flight"},
    {"HOTSTUFF_DTRACE": "1", "HOTSTUFF_TELEMETRY_INTERVAL": "soon",
     "HOTSTUFF_FLIGHT_CAPACITY": "4096", "HOTSTUFF_PYPROF_INTERVAL_MS": "0.5"},
    {"HOTSTUFF_FLIGHT_CAPACITY": "7", "HOTSTUFF_PYPROF_INTERVAL_MS": "x"},
], ids=lambda v: "+".join(k.removeprefix("HOTSTUFF_") for k in v) or "unset")
def test_telemetry_switches_mean_the_same_in_both_packages(telemetry_env, values):
    telemetry_env(**values)
    node = "pk/AbC+12=="
    assert telemetry_view(t_tm, node) == telemetry_view(j_tm, node)


@pytest.mark.parametrize("value, tracing", [("1", True), ("", False)])
def test_tracemalloc_switch_in_both_packages(telemetry_env, value, tracing):
    import tracemalloc

    from hotstuff_tpu.telemetry import resources as j_resources
    from hotstuff_tpu_torch.telemetry import resources as t_resources

    telemetry_env(HOTSTUFF_TRACEMALLOC=value)
    gauges = []
    try:
        for tm, resources in ((t_tm, t_resources), (j_tm, j_resources)):
            tm.enable()
            resources.install()
            assert tracemalloc.is_tracing() is tracing
            gauges.append(sorted(k for k in tm.get_registry().snapshot()["gauges"]
                                 if k.startswith("resource.tracemalloc")))
            tracemalloc.stop()
    finally:
        tracemalloc.stop()
    assert gauges[0] == gauges[1]
    assert bool(gauges[0]) is tracing


FAULTLINE_NODE_PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from hotstuff_tpu.faultline import hooks as j_hooks
from hotstuff_tpu_torch.faultline import hooks as t_hooks
print(json.dumps([t_hooks.NODE.get(), j_hooks.NODE.get()]))
"""


@pytest.mark.parametrize("value", ["n002", None], ids=["n002", "unset"])
def test_faultline_node_switch_means_the_same_in_both_packages(value):
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "HOTSTUFF_FAULTLINE_NODE"}
    if value is not None:
        env["HOTSTUFF_FAULTLINE_NODE"] = value
    out = subprocess.run([sys.executable, "-c", FAULTLINE_NODE_PROBE, str(repo)], env=env,
                         capture_output=True, text=True, timeout=60, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [value, value]


@pytest.mark.parametrize("armed", [True, False], ids=["scenario", "unset"])
def test_faultline_switch_arms_both_packages_nodes_alike(tmp_path, monkeypatch, armed):
    import contextvars

    import hotstuff_tpu.faultline as j_faultline
    import hotstuff_tpu.node.node as j_node
    import hotstuff_tpu_torch.faultline as t_faultline
    import hotstuff_tpu_torch.node.node as t_node

    from .test_torch_dataplane_e2e import write_worker_testbed

    committee_file, _, key_files = write_worker_testbed(tmp_path, 23590, workers=1)
    monkeypatch.delenv("HOTSTUFF_FAULTLINE", raising=False)
    if armed:
        path = str(tmp_path / "scenario.json")
        t_faultline.Scenario.load("benchmark/scenarios/partition.json").save(path)
        monkeypatch.setenv("HOTSTUFF_FAULTLINE", path)
    monkeypatch.setattr(t_node, "_armed", None)
    seen = []
    try:
        for node_mod, faultline in ((t_node, t_faultline), (j_node, j_faultline)):
            committee = node_mod.Committee.read(committee_file)
            name = node_mod.Secret.read(key_files[3]).name

            def arm():
                node_mod._install_faultline_from_env(committee, name)
                return faultline.hooks.NODE.get()

            identity = contextvars.copy_context().run(arm)
            plane = faultline.hooks.plane
            seen.append(None if plane is None else (
                identity, plane.schedule.trace(), sorted(plane.addr_to_node.items()),
                sorted(plane.consensus_addrs)))
    finally:
        t_faultline.uninstall()
        j_faultline.uninstall()
    assert seen[0] == seen[1]
    assert (seen[0] is not None) is armed
    if armed:
        assert seen[0][0] == "n003"


NET_PROBE = r"""
import asyncio, json, sys
sys.path.insert(0, sys.argv[1])
import hotstuff_tpu.network as j_network
import hotstuff_tpu_torch.network as t_network
from hotstuff_tpu.network import native as j_native
from hotstuff_tpu_torch.network import native as t_native

async def rings():
    return [t_native.NativeTransport.get()._ring_enabled, j_native.NativeTransport.get()._ring_enabled]

print(json.dumps({
    "classes": [[m.Receiver.__name__, m.SimpleSender.__name__, m.ReliableSender.__name__]
                for m in (t_network, j_network)],
    "ring": asyncio.run(rings()),
}))
"""


def run_probe(probe: str, env_set: dict, *args: str):
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k not in ("HOTSTUFF_NET", "HOTSTUFF_CMD_RING")}
    env.update(env_set)
    out = subprocess.run([sys.executable, "-c", probe, str(repo), *args], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


NATIVE = ["NativeReceiver", "NativeSimpleSender", "NativeReliableSender"]
ASYNCIO = ["Receiver", "SimpleSender", "ReliableSender"]


@pytest.mark.parametrize("net,classes", [("native", NATIVE), ("NATIVE", NATIVE),
                                         ("asyncio", ASYNCIO), (None, ASYNCIO)],
                         ids=["native", "upper-case", "asyncio", "unset"])
@pytest.mark.parametrize("ring,enabled", [("0", False), ("1", True), (None, True)],
                         ids=["ring-0", "ring-1", "ring-unset"])
def test_net_switches_mean_the_same_in_both_packages(net, classes, ring, enabled):
    env = {k: v for k, v in (("HOTSTUFF_NET", net), ("HOTSTUFF_CMD_RING", ring)) if v is not None}
    result = run_probe(NET_PROBE, env)
    assert result["classes"] == [classes, classes]
    assert result["ring"] == [enabled, enabled]


BROKEN_NET_PROBE = r"""
import ctypes, json, shutil, sys
sys.path.insert(0, sys.argv[1])
mode = sys.argv[2]
from hotstuff_tpu_torch.utils import kernel_build
if mode == "build":
    # No g++ and no library built yet.
    kernel_build.native_path = lambda source, extra=(): kernel_build.BUILD_ROOT / "missing" / "lib.so"
    kernel_build.shutil = type("NoGxx", (), {"which": staticmethod(lambda name: None)})
else:
    # The library is there but cannot be loaded.
    real = ctypes.CDLL
    def refuse(name, *a, **kw):
        if "netcore" in str(name) or "libhsnet" in str(name):
            raise OSError(f"cannot load {name}")
        return real(name, *a, **kw)
    ctypes.CDLL = refuse
out = {}
try:
    import hotstuff_tpu_torch.network as t_network
    out["port"] = t_network.Receiver.__name__
except Exception as e:
    out["port"] = type(e).__name__
if mode == "load":
    import hotstuff_tpu.network as j_network
    out["reference"] = j_network.Receiver.__name__
print(json.dumps(out))
"""


@pytest.mark.parametrize("mode,raised", [("build", "KernelBuildError"), ("load", "OSError")])
def test_native_switch_with_a_failing_library_raises_where_the_reference_falls_back(mode, raised):
    result = run_probe(BROKEN_NET_PROBE, {"HOTSTUFF_NET": "native"}, mode)
    assert result["port"] == raised
    if mode == "load":
        assert result["reference"] == "Receiver"  # the reference keeps asyncio


@pytest.mark.parametrize("value,groups", [(None, 0), ("0", 0), ("4", 4), ("8", 8), ("junk", 0),
                                          ("-2", 0), ("", 0)])
def test_engine_groups_switch_means_the_same_in_both_packages(monkeypatch, value, groups):
    from hotstuff_tpu.parallel import engine_groups as j_groups
    from hotstuff_tpu_torch.parallel import engine_groups as t_groups

    if value is None:
        monkeypatch.delenv("HOTSTUFF_ENGINE_GROUPS", raising=False)
    else:
        monkeypatch.setenv("HOTSTUFF_ENGINE_GROUPS", value)
    assert t_groups.groups_from_env() == j_groups.groups_from_env() == groups
