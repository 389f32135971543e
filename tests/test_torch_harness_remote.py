"""The port's remote testbed harness (``hotstuff_tpu_torch/benchmark/``
``settings.py``, ``instance.py``, ``remote.py`` and ``netns.py``) held to the
reference's (``benchmark/``) on the same inputs, with no real ``ssh``,
``scp``, ``ip``, ``tc`` or ``pkill``:

- ``RemoteBench``'s flow (the four cases of ``tests/test_remote_bench.py``)
  through one fake SSH fabric in both packages; the port's command strings
  and ``scp`` argv are the reference's with the package name mapped and
  nothing else, and each package's node reads the committee, parameters
  and key files that the other's ``config`` uploads;
- ``Settings.load`` of both ``settings.json`` copies, and its error;
- ``InstanceManager``'s error without boto3 and its EC2 calls with a fake
  one;
- ``netns``'s ``ip``/``tc`` argv, the printed fallback line, the scenario
  bytes and the ``RemoteBench`` calls of ``main``, and ``NetnsRunner``'s
  file mapping under a work root in ``tmp_path``.

``subprocess.run`` is replaced by a recorder that fails on any program it
was not told to expect, and ``subprocess.Popen`` by one that refuses to
start ``ssh``, ``scp``, ``ip``, ``tc`` or ``pkill``. Tolerance: exact
equality. No port is bound.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import types

import pytest

import benchmark.instance as j_instance
import benchmark.netns as j_netns
import benchmark.remote as j_remote
import benchmark.settings as j_settings
import hotstuff_tpu.faultline as j_faultline
import hotstuff_tpu.node.config as j_config
import hotstuff_tpu_torch.faultline as t_faultline
import hotstuff_tpu_torch.node.config as t_config
from hotstuff_tpu_torch.benchmark import instance as t_instance
from hotstuff_tpu_torch.benchmark import netns as t_netns
from hotstuff_tpu_torch.benchmark import remote as t_remote
from hotstuff_tpu_torch.benchmark import settings as t_settings
from tests.test_remote_bench import CLIENT_LOG, HOSTS, NODE_LOG

PACKAGES = {
    "reference": types.SimpleNamespace(remote=j_remote, settings=j_settings, netns=j_netns,
                                       instance=j_instance, config=j_config,
                                       faultline=j_faultline),
    "port": types.SimpleNamespace(remote=t_remote, settings=t_settings, netns=t_netns,
                                  instance=t_instance, config=t_config, faultline=t_faultline),
}
FORBIDDEN = {"ssh", "scp", "ip", "tc", "pkill"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mapped(text: str) -> str:
    """A port string in the reference's words: the package name mapped back."""
    return text.replace("hotstuff_tpu_torch", "hotstuff_tpu")


class GuardedPopen(subprocess.Popen):
    def __init__(self, args, *rest, **kwargs):
        program = args[0] if isinstance(args, (list, tuple)) else str(args).split()[0]
        if os.path.basename(str(program)) in FORBIDDEN:
            raise AssertionError(f"a real {program} was about to run: {args}")
        super().__init__(args, *rest, **kwargs)


@pytest.fixture(autouse=True)
def no_real_network_tools(monkeypatch):
    monkeypatch.setattr(subprocess, "Popen", GuardedPopen)


def settings_of(package: str):
    return PACKAGES[package].settings.Settings(
        testbed="smoke", key_name="k", key_path="/dev/null", consensus_port=8000,
        mempool_port=7000, front_port=6000, repo_name="repo",
        repo_url="https://example.invalid/repo.git", branch="main",
        instance_type="m5d.8xlarge", aws_regions=["us-east-1"])


class FakeSSHFabric:
    """Routes ``ssh``/``scp`` argv to per-host sandbox directories (as
    ``tests/test_remote_bench.py``'s fabric does, for either package's node
    command) and records every argv; any other program fails."""

    def __init__(self, root: str) -> None:
        self.root = root
        self.argv: list[list[str]] = []
        self.commands: list[tuple[str, str]] = []  # (host, command)

    def host_dir(self, host: str) -> str:
        d = os.path.join(self.root, host)
        os.makedirs(d, exist_ok=True)
        return d

    def _resolve(self, host: str, path: str) -> str:
        full = os.path.join(self.host_dir(host), path.replace("~/", "").lstrip("/"))
        os.makedirs(os.path.dirname(full), exist_ok=True)
        return full

    def __call__(self, argv, **kwargs):
        self.argv.append(list(argv))
        if argv[0] == "ssh":
            host, command = argv[-2].split("@", 1)[1], argv[-1]
            self.commands.append((host, command))
            if "node.client" in command:
                with open(self._resolve(host, "bench/client.log"), "w") as f:
                    f.write(CLIENT_LOG)
            elif re.search(r"-m hotstuff_tpu(_torch)?\.node run", command):
                with open(self._resolve(host, "bench/node.log"), "w") as f:
                    f.write(NODE_LOG)
            if "mkdir -p bench" in command:
                os.makedirs(os.path.join(self.host_dir(host), "bench"), exist_ok=True)
            return subprocess.CompletedProcess(argv, 0, stdout="", stderr="")
        if argv[0] == "scp":
            def local(spec: str) -> str:
                if spec.startswith("ubuntu@"):
                    host, path = spec[len("ubuntu@"):].split(":", 1)
                    return self._resolve(host, path)
                return spec

            with open(local(argv[-2]), "rb") as s, open(local(argv[-1]), "wb") as d:
                d.write(s.read())
            return subprocess.CompletedProcess(argv, 0, stdout=b"", stderr=b"")
        raise AssertionError(f"unexpected subprocess call: {argv}")


@pytest.fixture()
def fabric(tmp_path, monkeypatch):
    fake = FakeSSHFabric(str(tmp_path / "hosts"))
    monkeypatch.setattr(subprocess, "run", fake)
    monkeypatch.setattr("time.sleep", lambda *_: None)
    monkeypatch.chdir(tmp_path)
    return fake


# -- RemoteBench: the reference's four cases, in both packages ---------------


def case_install_and_update(bench, fabric, tmp_path):
    bench.install()
    bench.update()
    for host in HOSTS:
        cmds = [c for h, c in fabric.commands if h == host]
        assert any("git clone" in c for c in cmds), host
        assert any("git pull" in c for c in cmds), host


def case_config(bench, fabric, tmp_path):
    bench.config(work_dir=str(tmp_path / "wd"))
    key_names = set()
    for host in HOSTS:
        bench_dir = os.path.join(fabric.host_dir(host), "bench")
        with open(os.path.join(bench_dir, "committee.json")) as f:
            committee = json.load(f)
        assert len(committee["consensus"]["authorities"]) == len(HOSTS)
        addrs = {a["address"] for a in committee["consensus"]["authorities"].values()}
        assert addrs == {f"{h}:8000" for h in HOSTS}
        with open(os.path.join(bench_dir, "parameters.json")) as f:
            params = json.load(f)
        assert "consensus" in params and "mempool" in params
        with open(os.path.join(bench_dir, "key.json")) as f:
            key_names.add(json.load(f)["name"])
    assert len(key_names) == len(HOSTS)


def case_run(bench, fabric, tmp_path):
    bench.config(work_dir="wd")
    summary = bench.run(rate=1_000, tx_size=512, duration=10, timeout_delay=1_000).result()
    assert "Committee size: 4 nodes" in summary
    assert "Input rate: 1,000 tx/s" in summary
    assert re.search(r"End-to-end latency: \d+ ms", summary)
    boots = [c for _, c in fabric.commands if "nohup" in c]
    first_node = next(i for i, c in enumerate(boots) if "node run" in c)
    assert all("node.client" in c for c in boots[:first_node])
    assert len(boots) == 2 * len(HOSTS)


def case_run_with_faults(bench, fabric, tmp_path):
    bench.config(work_dir="wd")
    parser = bench.run(rate=900, tx_size=512, duration=5, faults=1, timeout_delay=1_000)
    boots = [(h, c) for h, c in fabric.commands if "nohup" in c]
    assert all(h != HOSTS[-1] for h, _ in boots)
    assert "Faults: 1 nodes" in parser.result()


@pytest.mark.parametrize("package", sorted(PACKAGES))
@pytest.mark.parametrize("case", [case_install_and_update, case_config, case_run,
                                  case_run_with_faults], ids=lambda c: c.__name__[5:])
def test_remote_bench_flow(fabric, tmp_path, package, case):
    case(PACKAGES[package].remote.RemoteBench(settings_of(package), HOSTS), fabric, tmp_path)


def drive(package: str, root, monkeypatch) -> FakeSSHFabric:
    """The whole flow, kill included, with a node env, in ``root``."""
    os.makedirs(root)
    monkeypatch.chdir(root)
    fake = FakeSSHFabric(str(root / "hosts"))
    monkeypatch.setattr(subprocess, "run", fake)
    bench = PACKAGES[package].remote.RemoteBench(settings_of(package), HOSTS)
    bench.install()
    bench.update()
    bench.config(work_dir="wd")
    bench.run(rate=1_000, tx_size=512, duration=5, faults=1, timeout_delay=1_000,
              node_env="HOTSTUFF_CRYPTO_BACKEND=cpu HOTSTUFF_FAULTLINE=~/bench/chaos.json")
    bench.kill()
    return fake


def test_port_commands_are_the_references_with_the_package_name_mapped(tmp_path, monkeypatch):
    monkeypatch.setattr("time.sleep", lambda *_: None)
    theirs = drive("reference", tmp_path / "reference", monkeypatch)
    ours = drive("port", tmp_path / "port", monkeypatch)
    assert [[mapped(a) for a in argv] for argv in ours.argv] == theirs.argv
    commands = [c for _, c in ours.commands]
    assert any("nohup python3 -m hotstuff_tpu_torch.node.client " in c for c in commands)
    assert any("HOTSTUFF_CRYPTO_BACKEND=cpu HOTSTUFF_FAULTLINE=~/bench/chaos.json nohup "
               "python3 -m hotstuff_tpu_torch.node run " in c for c in commands)
    assert "pkill -f hotstuff_tpu_torch || true" in commands
    assert all(argv[0] in ("ssh", "scp") for argv in ours.argv)


def authorities(committee) -> dict:
    return {pk.encode_base64(): (a.stake, tuple(a.address))
            for pk, a in committee.consensus.authorities.items()}


@pytest.mark.parametrize("writer,reader", [("port", "reference"), ("reference", "port")])
def test_each_packages_node_reads_the_files_the_others_config_uploads(
        fabric, tmp_path, writer, reader):
    bench = PACKAGES[writer].remote.RemoteBench(settings_of(writer), HOSTS)
    bench.config(work_dir=str(tmp_path / "wd"))
    w, r = PACKAGES[writer].config, PACKAGES[reader].config
    for host in HOSTS:
        bench_dir = os.path.join(fabric.host_dir(host), "bench")
        path = os.path.join(bench_dir, "committee.json")
        theirs, ours = r.Committee.read(path), w.Committee.read(path)
        assert authorities(theirs) == authorities(ours)
        assert set(authorities(theirs).values()) == {(1, (h, 8000)) for h in HOSTS}
        mempool = {pk.encode_base64(): (a.transactions_address, a.mempool_address)
                   for pk, a in theirs.mempool.authorities.items()}
        assert sorted(mempool.values()) == sorted(((h, 6000), (h, 7000)) for h in HOSTS)
        key = os.path.join(bench_dir, "key.json")
        assert r.Secret.read(key).name.encode_base64() == w.Secret.read(key).name.encode_base64()
        params = os.path.join(bench_dir, "parameters.json")
        reread = tmp_path / f"{host}-parameters.json"
        r.Parameters.read(params).write(str(reread))
        assert json.loads(reread.read_text()) == json.loads(open(params).read())


# -- Settings ------------------------------------------------------------------


def test_settings_copies_load_alike_and_fail_alike(tmp_path):
    ours_path = os.path.join(REPO, "hotstuff_tpu_torch", "benchmark", "settings.json")
    theirs_path = os.path.join(REPO, "benchmark", "settings.json")
    with open(ours_path, "rb") as a, open(theirs_path, "rb") as b:
        assert a.read() == b.read()
    ours, theirs = t_settings.Settings.load(ours_path), j_settings.Settings.load(theirs_path)
    assert vars(ours) == vars(theirs)
    assert ours.consensus_port == 8000 and ours.aws_regions[0] == "us-east-1"
    data = json.loads(open(theirs_path).read())
    del data["ports"]["mempool"]
    broken = tmp_path / "settings.json"
    broken.write_text(json.dumps(data))
    messages = []
    for module in (t_settings, j_settings):
        with pytest.raises(module.SettingsError) as e:
            module.Settings.load(str(broken))
        messages.append(str(e.value))
    assert messages[0] == messages[1] and "mempool" in messages[0]
    for module in (t_settings, j_settings):
        with pytest.raises(module.SettingsError):
            module.Settings.load(str(tmp_path / "missing.json"))


# -- InstanceManager -----------------------------------------------------------


def test_instance_manager_without_boto3_raises_the_references_error(monkeypatch):
    messages = []
    for package in ("port", "reference"):
        module = PACKAGES[package].instance
        monkeypatch.setattr(module, "HAVE_BOTO3", False)
        with pytest.raises(module.AWSError) as e:
            module.InstanceManager(settings_of(package))
        messages.append(str(e.value))
    assert messages[0] == messages[1] and "boto3" in messages[0]


class FakeEC2:
    """One region's EC2 client: records each call with its arguments."""

    def __init__(self, region: str, calls: list) -> None:
        self.region, self.calls = region, calls

    def _record(self, name, kwargs):
        self.calls.append((self.region, name, json.dumps(kwargs, sort_keys=True)))

    def describe_images(self, **kwargs):
        self._record("describe_images", kwargs)
        return {"Images": [{"ImageId": "ami-old", "CreationDate": "2024-01-01"},
                           {"ImageId": "ami-new", "CreationDate": "2025-06-01"}]}

    def run_instances(self, **kwargs):
        self._record("run_instances", kwargs)

    def describe_instances(self, **kwargs):
        self._record("describe_instances", kwargs)
        return {"Reservations": [{"Instances": [
            {"InstanceId": f"i-{self.region}-1", "PublicIpAddress": f"{self.region}.1"},
            {"InstanceId": f"i-{self.region}-2"}]}]}

    def terminate_instances(self, **kwargs):
        self._record("terminate_instances", kwargs)


def test_instance_manager_makes_the_references_ec2_calls(monkeypatch, capsys):
    results = {}
    for package in ("reference", "port"):
        module, calls = PACKAGES[package].instance, []
        fake = types.SimpleNamespace(
            client=lambda name, region_name, calls=calls: (
                calls.append(("client", name, region_name)) or FakeEC2(region_name, calls)))
        monkeypatch.setattr(module, "HAVE_BOTO3", True)
        monkeypatch.setattr(module, "boto3", fake, raising=False)
        settings = settings_of(package)
        settings.aws_regions = ["us-east-1", "eu-north-1"]
        manager = module.InstanceManager(settings)
        manager.create(2)
        hosts = manager.hosts()
        manager.terminate()
        results[package] = (calls, hosts, capsys.readouterr().out)
    assert results["port"] == results["reference"]
    calls, hosts, out = results["port"]
    assert hosts == ["us-east-1.1", "eu-north-1.1"]
    assert '"ImageId": "ami-new"' in next(c[2] for c in calls if c[1] == "run_instances")
    assert out.count("created 2 instances in") == 2


# -- netns -------------------------------------------------------------------


class FakeHost:
    """``subprocess.run`` for ``netns``: records every argv, answers ``ip
    netns list`` with ``listing``, fails ``tc`` when ``tc_fails``, and raises
    on a program it was not told to expect."""

    def __init__(self, expect: set[str], listing: str = "", tc_fails: bool = False) -> None:
        self.expect, self.listing, self.tc_fails = expect, listing, tc_fails
        self.argv: list[list[str]] = []
        self.kwargs: list[dict] = []

    def __call__(self, argv, check=True, **kwargs):
        if argv[0] not in self.expect:
            raise AssertionError(f"unexpected subprocess call: {argv}")
        self.argv.append(list(argv))
        self.kwargs.append(kwargs)
        if argv[:3] == ["ip", "netns", "list"]:
            return subprocess.CompletedProcess(argv, 0, stdout=self.listing, stderr="")
        if "tc" in argv and self.tc_fails:
            return subprocess.CompletedProcess(
                argv, 2, stdout="", stderr="Error: Specified qdisc kind is unknown.\n")
        return subprocess.CompletedProcess(argv, 0, stdout="", stderr="")


NETNS_HOSTS = ["10.99.0.1", "10.99.0.2", "10.99.0.3", "10.99.0.4"]
LISTING = "hs1 (id: 0)\nhs2 (id: 1)\nother (id: 2)\n\n"


def test_netns_setup_and_teardown_issue_the_references_argv(monkeypatch):
    argv = {}
    for package in ("reference", "port"):
        fake = FakeHost({"ip"}, listing=LISTING)
        monkeypatch.setattr(subprocess, "run", fake)
        hosts = PACKAGES[package].netns.setup(4)
        PACKAGES[package].netns.teardown()
        argv[package] = (hosts, fake.argv)
    assert argv["port"] == argv["reference"]
    hosts, calls = argv["port"]
    assert hosts == NETNS_HOSTS
    assert ["ip", "netns", "del", "hs1"] in calls and ["ip", "netns", "del", "other"] not in calls
    assert ["ip", "link", "add", "hsv3", "type", "veth", "peer", "name", "eth0", "netns",
            "hs4"] in calls


@pytest.mark.parametrize("tc_fails", [False, True], ids=["netem", "no-netem"])
@pytest.mark.parametrize("shape", [(80.0, 10.0, 1.5), (0.0, 0.0, 2.0), (0.0, 0.0, 0.0)],
                         ids=["rtt-jitter-loss", "loss", "none"])
def test_apply_netem_issues_the_references_argv_and_lines(monkeypatch, capsys, tc_fails, shape):
    rtt, jitter, loss = shape
    seen = {}
    for package in ("reference", "port"):
        fake = FakeHost({"ip"}, tc_fails=tc_fails)
        monkeypatch.setattr(subprocess, "run", fake)
        ok = PACKAGES[package].netns.apply_netem(["10.99.0.1", "10.99.0.2"], rtt, jitter, loss)
        seen[package] = (ok, fake.argv, capsys.readouterr().out)
    assert seen["port"] == seen["reference"]
    ok, calls, out = seen["port"]
    if rtt == loss == 0:
        assert ok and calls == [] and out == ""
    elif tc_fails:
        assert not ok and len(calls) == 1
        assert out == ("tc netem unavailable (Error: Specified qdisc kind is unknown.); "
                       "falling back to faultline app-layer WAN shaping\n")
    else:
        assert ok and len(calls) == 2 and out == ""
        assert calls[0][:11] == ["ip", "netns", "exec", "hs1", "tc", "qdisc", "add", "dev",
                                 "eth0", "root", "netem"]


class RecordingRunner:
    """Stands for the ``NetnsRunner`` a ``RemoteBench`` recorder was given:
    records its repository and every ``put`` and copies nothing."""

    def __init__(self, runner, calls: list) -> None:
        self.repo_path, self.calls = runner.repo_path, calls

    def put(self, host, local, remote):
        self.calls.append(("runner.put", host, local, remote))


def remote_bench_recorder(calls: list, tmp_path):
    class Parser:
        def result(self):
            return "SUMMARY (recorded)"

    class RemoteBench:
        def __init__(self, settings, hosts, runner=None):
            calls.append(("init", json.dumps(vars(settings), sort_keys=True), list(hosts),
                          type(runner).__name__))
            self.runner = RecordingRunner(runner, calls)

        def install(self):
            calls.append(("install",))

        def config(self, work_dir=".remote-bench", node_params=None):
            path = tmp_path / "params.json"
            node_params.write(str(path))
            calls.append(("config", work_dir, json.loads(path.read_text())))

        def run(self, **kwargs):
            calls.append(("run", json.dumps(kwargs, sort_keys=True)))
            return Parser()

    return RemoteBench


@pytest.mark.parametrize("flags", [
    ["--rtt", "80", "--jitter", "10", "--loss", "1"],
    ["--partition", "0,1|2,3", "--partition-at", "3", "--partition-heal", "6"],
    [],
], ids=["rtt", "partition", "plain"])
def test_netns_main_writes_the_references_scenario_and_drives_remote_bench_alike(
        monkeypatch, capsys, tmp_path, flags):
    work_root = str(tmp_path / "hosts")
    seen = {}
    for package in ("reference", "port"):
        p, calls, saved = PACKAGES[package], [], {}
        fake = FakeHost({"ip", "pkill"}, listing=LISTING, tc_fails=True)
        monkeypatch.setattr(subprocess, "run", fake)
        monkeypatch.setattr("time.sleep", lambda *_: None)
        monkeypatch.setattr(p.netns, "WORK_ROOT", work_root)
        monkeypatch.setattr(p.remote, "RemoteBench", remote_bench_recorder(calls, tmp_path))
        save = p.faultline.Scenario.save

        def redirected(self, path, save=save, saved=saved, package=package):
            saved["path"] = path
            target = tmp_path / f"{package}-scenario.json"
            save(self, str(target))
            saved["bytes"] = target.read_bytes()

        monkeypatch.setattr(p.faultline.Scenario, "save", redirected)
        out_dir = tmp_path / f"{package}-out"
        argv = ["--hosts", "4", "--rate", "900", "--duration", "7", "--faults", "1",
                "--timeout", "2000", "--output", str(out_dir), *flags]
        if package == "reference":
            monkeypatch.setattr("sys.argv", ["netns.py", *argv])
            p.netns.main()
        else:
            p.netns.main(argv)
        outputs = {name: (out_dir / name).read_text() for name in os.listdir(out_dir)}
        seen[package] = (calls, saved, fake.argv, capsys.readouterr().out, outputs)
    assert seen["port"] == seen["reference"]
    calls, saved, argv, out, outputs = seen["port"]
    assert ["pkill", "-f", work_root] in argv and argv[-1] == ["ip", "link", "del", "hsbr0"]
    assert calls[0][2] == NETNS_HOSTS
    assert calls[0][3] == "NetnsRunner" and calls[2][2]["consensus"]["timeout_delay"] == 2000
    run = json.loads(calls[-1][1])
    assert run["faults"] == 1 and run["rate"] == 900 and run["timeout_delay"] == 2000
    if flags:
        assert saved["path"] == "/tmp/hs-netns-wan.json"
        events = json.loads(saved["bytes"])["events"]
        assert events[0]["kind"] == ("link" if "--rtt" in flags else "partition")
        puts = [c for c in calls if c[0] == "runner.put"]
        assert [c[1] for c in puts] == NETNS_HOSTS and puts[0][2:] == (
            "/tmp/hs-netns-wan.json", "bench/chaos.json")
        assert run["node_env"] == "HOTSTUFF_FAULTLINE=~/bench/chaos.json"
    else:
        assert saved == {} and run["node_env"] == ""
    assert out.endswith("SUMMARY (recorded)\n")
    assert list(outputs.values())[0].endswith("SUMMARY (recorded)\n")


def test_netns_runner_maps_execs_copies_and_clones_alike(monkeypatch, tmp_path):
    seen = {}
    for package in ("reference", "port"):
        module = PACKAGES[package].netns
        root = tmp_path / package / "hosts"
        monkeypatch.setattr(module, "WORK_ROOT", str(root))
        fake = FakeHost({"ip", "git"})
        monkeypatch.setattr(subprocess, "run", fake)
        runner = module.NetnsRunner(repo_path="/src/repo")
        host = "10.99.0.3"
        maps = [os.path.relpath(runner._map(host, r), root)
                for r in ("~/bench/key.json", "bench/node.log")] + [runner._map(host, "/abs/x")]
        local = tmp_path / package / "committee.json"
        local.parent.mkdir(exist_ok=True)
        local.write_text(f"committee of {package}")
        runner.put(host, str(local), "bench/committee.json")
        copied = (root / host / "bench" / "committee.json").read_text()
        back = tmp_path / package / "back.json"
        runner.get(host, "~/bench/committee.json", str(back))
        runner.exec(host, "echo hi", check=False)
        runner.provision(host)
        home = fake.kwargs[0]
        seen[package] = (maps, copied == local.read_text() == back.read_text(),
                         [[a.replace(str(root), "<root>") for a in argv] for argv in fake.argv],
                         os.path.relpath(home["cwd"], root),
                         os.path.relpath(home["env"]["HOME"], root))
    assert seen["port"] == seen["reference"]
    maps, same, argv, cwd, home = seen["port"]
    assert maps == ["10.99.0.3/bench/key.json", "10.99.0.3/bench/node.log", "/abs/x"] and same
    assert argv == [["ip", "netns", "exec", "hs3", "bash", "-c", "echo hi"],
                    ["git", "clone", "--depth", "1", "file:///src/repo", "<root>/10.99.0.3/repo"]]
    assert cwd == home == "10.99.0.3"


def test_netns_runner_defaults_to_the_repository_root():
    assert t_netns.NetnsRunner().repo_path == j_netns.NetnsRunner().repo_path == REPO
