"""Local benchmark: boot a committee of real node processes plus load-
generating clients on localhost, then parse their logs into the SUMMARY
block (reference ``benchmark/benchmark/local.py``), on the port.

Port copy of the reference's ``benchmark/local.py`` (``LocalBench``,
``BenchError``, the chaos supervision and the availability audit), over
the port's node config, mempool, consensus, faultline and store. The node
and client processes are ``python -m hotstuff_tpu_torch.node`` and
``python -m hotstuff_tpu_torch.node.client``. Two things differ from the
reference: ``crypto_backend`` defaults to ``cuda`` (the reference's to
``cpu``), and ``run`` resolves the card before it boots anything when the
backend's name holds ``cuda``, so without a card it raises at once where
each node would otherwise fail at boot and the port wait run out. Nothing
is left out.

Differences from the reference: processes are supervised directly (no tmux)
and there is no cargo build step (Python nodes launch as subprocesses with
stderr redirected to per-role log files, like the reference's
``local.py:25-28``).
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import sys
import time

from hotstuff_tpu_torch.consensus import Authority as CAuth
from hotstuff_tpu_torch.consensus import Committee as CCommittee
from hotstuff_tpu_torch.consensus import Parameters as CParams
from hotstuff_tpu_torch.mempool import Authority as MAuth
from hotstuff_tpu_torch.mempool import Committee as MCommittee
from hotstuff_tpu_torch.mempool import Parameters as MParams
from hotstuff_tpu_torch.mempool import WorkerEntry
from hotstuff_tpu_torch.node.config import Committee, Parameters, Secret

from .logs import LogParser

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


class BenchError(Exception):
    pass


class LocalBench:
    """Reference flow (``local.py:37-121``): clean state, generate N key
    files + committee json, start each client & node with stderr->logfile,
    sleep for the duration, kill, parse logs."""

    def __init__(
        self,
        nodes: int = 4,
        rate: int = 1_000,
        tx_size: int = 512,
        duration: int = 20,
        faults: int = 0,
        base_port: int = 9000,
        timeout_delay: int = 1_000,
        batch_size: int = 15_000,
        max_batch_delay: int = 10,
        work_dir: str = ".bench",
        crypto_backend: str = "cuda",
        telemetry: bool = False,
        chaos: str | None = None,
        workers: int = 0,
        retention_rounds: int = 0,
        client_extra: list[str] | None = None,
    ) -> None:
        self.nodes = nodes
        self.rate = rate
        self.tx_size = tx_size
        self.duration = duration
        self.faults = faults
        self.base_port = base_port
        self.timeout_delay = timeout_delay
        self.batch_size = batch_size
        self.max_batch_delay = max_batch_delay
        self.work_dir = os.path.abspath(work_dir)
        self.crypto_backend = crypto_backend
        self.telemetry = telemetry
        # Chaos mode: path to a faultline scenario JSON. Partition/link/
        # byzantine events run INSIDE each node process (the env-armed
        # FaultPlane); crash/restart events are enacted HERE by killing
        # and relaunching real node processes. After the run the
        # faultline checker judges the logs; the verdict lands in
        # ``self.chaos_verdict``.
        self.chaos = chaos
        self.chaos_verdict: dict | None = None
        # Conveyor data plane: worker shards per node. Port layout
        # extends the reference blocks — worker w of node i listens on
        # base + (3 + 2w) * n + i (client ingress) and
        # base + (4 + 2w) * n + i (peer port). Clients switch to the
        # sharded bundle generator targeting their node's ingress ports.
        self.workers = workers
        # Lazarus: snapshot/truncate retention depth in rounds (0 =
        # unbounded store, the historic behavior).
        self.retention_rounds = retention_rounds
        # Extra argv appended to every client (e.g. ``--fleet``/
        # ``--coalesce-bytes`` knobs from the fleet/sweep harnesses).
        self.client_extra = list(client_extra or [])
        self._procs: list[subprocess.Popen] = []
        self._node_procs: dict[int, subprocess.Popen] = {}
        self._node_cmds: dict[int, tuple[list, str]] = {}  # i -> (cmd, log)

    def _cleanup(self) -> None:
        # SIGTERM first: nodes flush their final telemetry snapshot +
        # trace tail from the signal handler (telemetry.arm_shutdown_flush)
        # — without this the last interval of every stream was lost.
        # SIGKILL after a short grace bounds the teardown; a node that
        # missed the window just loses its final line (the lenient stream
        # reader tolerates a truncated tail).
        procs = [*self._procs, *self._node_procs.values()]
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 5.0
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pass
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
        self._procs.clear()
        self._node_procs.clear()

    @staticmethod
    def _wait_for_ports(addresses, timeout: float) -> None:
        import socket

        deadline = time.monotonic() + timeout
        for host, port in addresses:
            while True:
                try:
                    with socket.create_connection((host, port), timeout=1):
                        break
                except OSError:
                    if time.monotonic() > deadline:
                        raise BenchError(
                            f"node on {host}:{port} did not come up in time"
                        ) from None
                    time.sleep(0.5)

    def run(self, debug: bool = False) -> LogParser:
        if "cuda" in self.crypto_backend:
            from hotstuff_tpu_torch.utils.device import resolve

            resolve("cuda")  # raises without a card, before any process starts
        shutil.rmtree(self.work_dir, ignore_errors=True)
        os.makedirs(self.work_dir, exist_ok=True)
        logs_dir = os.path.join(self.work_dir, "logs")
        os.makedirs(logs_dir)

        # Keys + committee (reference port layout: consensus, front, mempool
        # blocks of N ports each, ``config.py:81-90``).
        secrets = [Secret.new() for _ in range(self.nodes)]
        n = self.nodes
        consensus = CCommittee(
            authorities={
                s.name: CAuth(stake=1, address=("127.0.0.1", self.base_port + i))
                for i, s in enumerate(secrets)
            }
        )
        mempool = MCommittee(
            authorities={
                s.name: MAuth(
                    stake=1,
                    transactions_address=("127.0.0.1", self.base_port + n + i),
                    mempool_address=("127.0.0.1", self.base_port + 2 * n + i),
                    workers=[
                        WorkerEntry(
                            transactions_address=(
                                "127.0.0.1",
                                self.base_port + (3 + 2 * w) * n + i,
                            ),
                            worker_address=(
                                "127.0.0.1",
                                self.base_port + (4 + 2 * w) * n + i,
                            ),
                        )
                        for w in range(self.workers)
                    ],
                )
                for i, s in enumerate(secrets)
            }
        )
        committee_file = os.path.join(self.work_dir, "committee.json")
        Committee(consensus, mempool).write(committee_file)
        params_file = os.path.join(self.work_dir, "parameters.json")
        Parameters(
            CParams(
                timeout_delay=self.timeout_delay,
                retention_rounds=self.retention_rounds,
            ),
            MParams(
                batch_size=self.batch_size,
                max_batch_delay=self.max_batch_delay,
                workers=self.workers,
            ),
        ).write(params_file)

        key_files = []
        for i, s in enumerate(secrets):
            kf = os.path.join(self.work_dir, f"node_{i}.json")
            s.write(kf)
            key_files.append(kf)

        env = dict(os.environ)
        env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
        env["HOTSTUFF_CRYPTO_BACKEND"] = self.crypto_backend
        schedule = None
        if self.chaos:
            from hotstuff_tpu_torch.faultline import Scenario

            scenario = Scenario.load(self.chaos)
            schedule = scenario.compile([f"n{i:03d}" for i in range(n)])
            # Arm every node process's in-process fault plane; telemetry
            # rides along so the faultline.* counters exist in the
            # emitted snapshots.
            env["HOTSTUFF_FAULTLINE"] = os.path.abspath(self.chaos)
            self.telemetry = True
        if self.telemetry:
            # Nodes stream telemetry-<name>.jsonl next to their logs; the
            # SIGTERM-first teardown lets each node's signal handler flush
            # its final snapshot + trace tail. A short interval still
            # bounds the loss for nodes the chaos supervisor SIGKILLs.
            env["HOTSTUFF_TELEMETRY_DIR"] = logs_dir
            env.setdefault("HOTSTUFF_TELEMETRY_INTERVAL", "1")

        booted = self.nodes - self.faults  # faults = don't boot the last f
        try:
            # Boot clients first (they wait for node ports), then nodes
            # (reference ``remote.py:177-219`` order).
            for i in range(booted):
                front = f"127.0.0.1:{self.base_port + n + i}"
                node_addrs = [
                    f"127.0.0.1:{self.base_port + n + j}" for j in range(booted)
                ]
                shard_args = []
                if self.workers:
                    shards = ",".join(
                        f"127.0.0.1:{self.base_port + (3 + 2 * w) * n + i}"
                        for w in range(self.workers)
                    )
                    shard_args = ["--shards", shards]
                log_file = open(os.path.join(logs_dir, f"client-{i}.log"), "w")
                self._procs.append(
                    subprocess.Popen(
                        [
                            sys.executable,
                            "-m",
                            "hotstuff_tpu_torch.node.client",
                            front,
                            "--size",
                            str(self.tx_size),
                            "--rate",
                            str(self.rate // booted),
                            "--timeout",
                            str(self.timeout_delay),
                            *shard_args,
                            *self.client_extra,
                            "--nodes",
                            *node_addrs,
                        ],
                        stderr=log_file,
                        env=env,
                        cwd=REPO_ROOT,
                    )
                )
            for i in range(booted):
                log_path = os.path.join(logs_dir, f"node-{i}.log")
                cmd = [
                    sys.executable,
                    "-m",
                    "hotstuff_tpu_torch.node",
                    # default verbosity is INFO; -v adds DEBUG, which
                    # would skew the measured window.
                    *(["-v"] if debug else []),
                    "run",
                    "--keys",
                    key_files[i],
                    "--committee",
                    committee_file,
                    "--store",
                    os.path.join(self.work_dir, f"db_{i}"),
                    "--parameters",
                    params_file,
                ]
                self._node_cmds[i] = (cmd, log_path)
                self._node_procs[i] = subprocess.Popen(
                    cmd,
                    stderr=open(log_path, "a"),
                    env=env,
                    cwd=REPO_ROOT,
                )

            # Python interpreter startup is expensive (~2s CPU each on this
            # class of machine) and all processes compete for cores: don't
            # start the measurement clock until every node actually listens.
            self._wait_for_ports(
                [("127.0.0.1", self.base_port + i) for i in range(booted)],
                timeout=30 * booted,
            )
            time.sleep(2 * self.timeout_delay / 1000)
            if schedule is None:
                time.sleep(self.duration)
            else:
                heal_counts = self._supervise_chaos(schedule, env)
        finally:
            self._cleanup()

        parser = LogParser.process(logs_dir, faults=self.faults)
        if schedule is not None:
            self.chaos_verdict = self._judge_chaos(
                logs_dir, schedule, heal_counts
            )
        return parser

    # -- chaos supervision ---------------------------------------------------

    def _restart_node(self, i: int, env: dict) -> None:
        cmd, log_path = self._node_cmds[i]
        self._node_procs[i] = subprocess.Popen(
            cmd, stderr=open(log_path, "a"), env=env, cwd=REPO_ROOT
        )

    @staticmethod
    def _commit_lines(logs_dir: str, i: int) -> list[tuple[int, str]]:
        import re

        path = os.path.join(logs_dir, f"node-{i}.log")
        try:
            with open(path) as f:
                text = f.read()
        except OSError:
            return []
        return [
            (int(r), d)
            for r, d in re.findall(r"FaultlineCommit r=(\d+) d=([0-9a-f]+)", text)
        ]

    def _supervise_chaos(self, schedule, env: dict) -> dict[int, int]:
        """Enact the schedule's crash/restart events against real node
        processes (partition/link/byzantine run inside the nodes via the
        env-armed planes) and snapshot per-node commit-line counts at the
        last heal — the liveness baseline ``_judge_chaos`` compares
        against. Virtual t=0 is the moment the committee finished
        booting, matching each node plane's process-boot anchor to within
        interpreter-startup skew."""
        logs_dir = os.path.join(self.work_dir, "logs")
        actions = sorted(
            (
                (e.at, e.kind, e.params["node"])
                for e in schedule.events
                if e.kind in ("crash", "restart")
            ),
        )
        heal_t = schedule.last_heal_time()
        heal_counts: dict[int, int] = {}
        t0 = time.monotonic()
        while True:
            elapsed = time.monotonic() - t0
            while actions and actions[0][0] <= elapsed:
                _, kind, node = actions.pop(0)
                i = int(node.lstrip("n"))
                proc = self._node_procs.get(i)
                if kind == "crash":
                    if proc is not None and proc.poll() is None:
                        proc.send_signal(signal.SIGKILL)
                        print(f"chaos: crashed node {i} at t={elapsed:.1f}s")
                elif proc is None or proc.poll() is not None:
                    self._restart_node(i, env)
                    print(f"chaos: restarted node {i} at t={elapsed:.1f}s")
            if not heal_counts and elapsed >= heal_t:
                heal_counts = {
                    i: len(self._commit_lines(logs_dir, i))
                    for i in range(self.nodes - self.faults)
                }
            if elapsed >= self.duration:
                # Recovery tail: a restarted node may still be walking a
                # long sync catch-up when the measurement window closes.
                # Give the committee a bounded extra window to prove
                # post-heal commit growth before the SIGKILL teardown —
                # the same grace the in-process harness grants.
                recovered = heal_counts and all(
                    len(self._commit_lines(logs_dir, i)) >= base + 3
                    for i, base in heal_counts.items()
                    if self._node_procs.get(i) is not None
                    and self._node_procs[i].poll() is None
                )
                if recovered or elapsed >= self.duration + 45:
                    break
            time.sleep(0.2)
        return heal_counts

    def _judge_chaos(self, logs_dir: str, schedule, heal_counts) -> dict:
        """Feed the scraped commit streams to the faultline checker.
        Per-line virtual times aren't in the logs; what liveness needs is
        only pre/post-heal attribution, which the heal-time count
        snapshot gives exactly."""
        from hotstuff_tpu_torch.faultline import CommitRecord, check

        heal_t = schedule.last_heal_time()
        commits = {}
        for i in range(self.nodes - self.faults):
            lines = self._commit_lines(logs_dir, i)
            cut = heal_counts.get(i, len(lines))
            commits[f"n{i:03d}"] = [
                CommitRecord(r, bytes.fromhex(d), 0.0 if k < cut else heal_t + 1.0)
                for k, (r, d) in enumerate(lines)
            ]
        verdict = check(schedule, commits)
        if self.workers:
            verdict["availability"] = self._audit_availability(
                logs_dir, schedule
            )
        return verdict

    def _audit_availability(self, logs_dir: str, schedule) -> dict:
        """The Conveyor invariant, audited end to end: every batch digest
        any node COMMITTED must resolve from at least f+1 honest nodes'
        on-disk stores after the run — the availability the certificate
        promised at ordering time, checked against reality."""
        import asyncio
        import base64
        import re

        from hotstuff_tpu_torch.faultline import check_availability
        from hotstuff_tpu_torch.store import Store

        booted = self.nodes - self.faults
        committed: set[bytes] = set()
        for i in range(booted):
            try:
                with open(os.path.join(logs_dir, f"node-{i}.log")) as f:
                    text = f.read()
            except OSError:
                continue
            for b64 in re.findall(r"Committed B\d+ -> ([^ \n]+=)", text):
                try:
                    raw = base64.standard_b64decode(b64)
                except ValueError:
                    continue
                if len(raw) == 32:
                    committed.add(raw)

        holders: dict[str, set[str]] = {d.hex(): set() for d in committed}

        async def scan() -> None:
            for i in range(booted):
                path = os.path.join(self.work_dir, f"db_{i}")
                if not os.path.isdir(path):
                    continue
                store = Store(path)
                try:
                    for d in committed:
                        if await store.read(d) is not None:
                            holders[d.hex()].add(f"n{i:03d}")
                finally:
                    store.close()

        asyncio.run(scan())
        return check_availability(schedule, set(holders), holders)
