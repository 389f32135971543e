"""Remote (multi-host) benchmark orchestration (reference
``benchmark/benchmark/remote.py``).

The reference drives AWS hosts over Fabric SSH; this harness needs no
fabric or boto3, so orchestration uses plain ``ssh``/``scp`` subprocesses
with the same flow (``remote.py:58-235``):

  install -> update -> config (generate keys/committee locally, upload)
  -> run (boot clients then nodes, sleep, kill) -> logs (download, parse)

Hosts come from ``Settings`` + an explicit host list (or the AWS
InstanceManager when boto3 is available). Crash-fault runs skip booting
the last ``faults`` hosts (``remote.py:273-275``).

Port copy of the reference's ``benchmark/remote.py`` (``BenchError``,
``SshRunner``, ``RemoteBench``), over the port's node config, consensus and
mempool parameters and ``LogParser``. Every command string is the
reference's with the package name mapped and nothing else: the hosts boot
``python3 -m hotstuff_tpu_torch.node.client`` and ``python3 -m
hotstuff_tpu_torch.node run``, and ``kill`` matches ``pkill -f
hotstuff_tpu_torch``. The committee, parameters and key files are the
reference's format (either package's node reads the other's). The remote
nodes verify under their own default backend, ``cuda``, unless ``node_env``
names another (``HOTSTUFF_CRYPTO_BACKEND=cpu ...``); the machine that
drives the run resolves no card. Nothing is left out.
"""

from __future__ import annotations

import os
import subprocess
import time

from hotstuff_tpu_torch.consensus import Authority as CAuth
from hotstuff_tpu_torch.consensus import Committee as CCommittee
from hotstuff_tpu_torch.consensus import Parameters as CParams
from hotstuff_tpu_torch.mempool import Authority as MAuth
from hotstuff_tpu_torch.mempool import Committee as MCommittee
from hotstuff_tpu_torch.mempool import Parameters as MParams
from hotstuff_tpu_torch.node.config import Committee, Parameters, Secret

from .logs import LogParser
from .settings import Settings
from .utils import PathMaker, Print


class BenchError(Exception):
    pass


class SshRunner:
    """Host access over plain ``ssh``/``scp`` subprocesses — the
    real-cluster transport (reference drives Fabric SSH the same way)."""

    def __init__(self, settings: Settings) -> None:
        self.settings = settings

    def exec(self, host: str, command: str, check: bool = True):
        return subprocess.run(
            [
                "ssh",
                "-i",
                self.settings.key_path,
                "-o",
                "StrictHostKeyChecking=no",
                f"ubuntu@{host}",
                command,
            ],
            check=check,
            capture_output=True,
            text=True,
        )

    def put(self, host: str, local: str, remote: str) -> None:
        subprocess.run(
            [
                "scp",
                "-i",
                self.settings.key_path,
                "-o",
                "StrictHostKeyChecking=no",
                local,
                f"ubuntu@{host}:{remote}",
            ],
            check=True,
            capture_output=True,
        )

    def get(self, host: str, remote: str, local: str) -> None:
        subprocess.run(
            [
                "scp",
                "-i",
                self.settings.key_path,
                "-o",
                "StrictHostKeyChecking=no",
                f"ubuntu@{host}:{remote}",
                local,
            ],
            check=True,
            capture_output=True,
        )

    def provision(self, host: str) -> None:
        """python + a clone of the repo (reference ``remote.py:58-83``
        installs rust; we install the python package). The hosts must
        already carry PyTorch built for CUDA and a card: these commands
        install neither."""
        cmd = " && ".join(
            [
                "sudo apt-get update",
                "sudo apt-get -y install python3 python3-pip git",
                f"(git clone {self.settings.repo_url} || true)",
            ]
        )
        self.exec(host, cmd)


class RemoteBench:
    def __init__(
        self, settings: Settings, hosts: list[str], runner=None
    ) -> None:
        self.settings = settings
        self.hosts = hosts
        # Pluggable host transport: SshRunner for real clusters;
        # hotstuff_tpu_torch.benchmark.netns.NetnsRunner gives each "host" its own kernel
        # network stack on one machine (real TCP over veth/bridge, real
        # process boot/kill, real log collection) when no ssh exists.
        self.runner = runner if runner is not None else SshRunner(settings)

    # -- ssh plumbing (kept as thin aliases; flow code reads better) --------

    def _ssh(self, host: str, command: str, check: bool = True):
        return self.runner.exec(host, command, check=check)

    def _upload(self, host: str, local: str, remote: str) -> None:
        self.runner.put(host, local, remote)

    def _download(self, host: str, remote: str, local: str) -> None:
        self.runner.get(host, remote, local)

    # -- benchmark flow -----------------------------------------------------

    def install(self) -> None:
        """Provision every host (reference ``remote.py:58-83``)."""
        for host in self.hosts:
            self.runner.provision(host)
            Print.info(f"installed on {host}")

    def update(self) -> None:
        """git pull on every host (reference ``remote.py:117-128``)."""
        repo = self.settings.repo_name
        cmd = f"cd {repo} && git fetch && git checkout {self.settings.branch} && git pull"
        for host in self.hosts:
            self._ssh(host, cmd)

    def config(self, work_dir: str = ".remote-bench", node_params: Parameters | None = None):
        """Generate keys + committee locally, upload to every host
        (reference ``remote.py:130-175``)."""
        os.makedirs(work_dir, exist_ok=True)
        secrets = [Secret.new() for _ in self.hosts]
        consensus = CCommittee(
            authorities={
                s.name: CAuth(stake=1, address=(h, self.settings.consensus_port))
                for s, h in zip(secrets, self.hosts)
            }
        )
        mempool = MCommittee(
            authorities={
                s.name: MAuth(
                    stake=1,
                    transactions_address=(h, self.settings.front_port),
                    mempool_address=(h, self.settings.mempool_port),
                )
                for s, h in zip(secrets, self.hosts)
            }
        )
        committee_file = os.path.join(work_dir, "committee.json")
        Committee(consensus, mempool).write(committee_file)
        params_file = os.path.join(work_dir, "parameters.json")
        (node_params or Parameters(CParams(), MParams())).write(params_file)

        key_files = []
        for i, s in enumerate(secrets):
            kf = os.path.join(work_dir, f"node_{i}.json")
            s.write(kf)
            key_files.append(kf)

        for i, host in enumerate(self.hosts):
            self._ssh(host, "mkdir -p bench", check=False)
            self._upload(host, committee_file, "bench/committee.json")
            self._upload(host, params_file, "bench/parameters.json")
            self._upload(host, key_files[i], "bench/key.json")
        return committee_file

    def kill(self) -> None:
        for host in self.hosts:
            self._ssh(host, "pkill -f hotstuff_tpu_torch || true", check=False)

    def run(
        self,
        rate: int,
        tx_size: int,
        duration: int,
        faults: int = 0,
        timeout_delay: int = 5_000,
        node_env: str = "",
    ) -> LogParser:
        """Boot clients then nodes, sleep for the duration, kill, download
        and parse logs (reference ``remote.py:177-235``). ``node_env`` is
        a shell ``VAR=value ...`` prefix applied to the node processes
        (e.g. ``HOTSTUFF_FAULTLINE=~/bench/chaos.json`` arms fault
        injection on every host)."""
        self.kill()
        repo = self.settings.repo_name
        booted = self.hosts[: len(self.hosts) - faults]
        node_addrs = " ".join(
            f"{h}:{self.settings.front_port}" for h in booted
        )
        env_prefix = f"{node_env} " if node_env else ""
        for host in booted:
            client = (
                f"cd {repo} && nohup python3 -m hotstuff_tpu_torch.node.client "
                f"{host}:{self.settings.front_port} --size {tx_size} "
                f"--rate {rate // len(booted)} --timeout {timeout_delay} "
                f"--nodes {node_addrs} > /dev/null 2> ~/bench/client.log &"
            )
            self._ssh(host, client)
        for host in booted:
            node = (
                f"cd {repo} && {env_prefix}nohup python3 -m hotstuff_tpu_torch.node run "
                f"--keys ~/bench/key.json --committee ~/bench/committee.json "
                f"--store ~/bench/db --parameters ~/bench/parameters.json "
                f"> /dev/null 2> ~/bench/node.log &"
            )
            self._ssh(host, node)

        time.sleep(2 * timeout_delay / 1000 + duration)
        self.kill()

        logs_dir = PathMaker.logs_path()
        os.makedirs(logs_dir, exist_ok=True)
        for i, host in enumerate(booted):
            self._download(host, "~/bench/client.log", PathMaker.client_log_file(i))
            self._download(host, "~/bench/node.log", PathMaker.node_log_file(i))
        return LogParser.process(logs_dir, faults=faults)
