"""Network-namespace testbed: real multi-host benchmarking on one machine.

The reference proves its remote flow on AWS (``benchmark/benchmark/
remote.py`` + boto3); where neither ssh nor cloud access is at hand, the
multi-host flow runs against kernel network namespaces instead:
every "host" gets its own network stack (netns) with an IP on a shared
bridge, its own home directory with its own git clone of the repo, and
its own node/client processes. Everything the ssh flow exercises is real
here — TCP between distinct stacks over veth/bridge, process boot by
command, log download, crash-fault host skipping — except the transport
used to reach the host (``ip netns exec`` instead of ssh) and the
underlying filesystem (shared, so "upload" is a copy).

Topology: bridge ``hsbr0`` at 10.99.0.254/24; host i = netns ``hs<i>``
with eth0 = 10.99.0.<i>/24. Requires root: it adds and deletes the
bridge, veths, namespaces and ``tc`` qdiscs on the machine it runs on.

    python -m hotstuff_tpu_torch.benchmark.netns --hosts 4 --rate 1000 --duration 20

Port copy of the reference's ``benchmark/netns.py`` (``setup``,
``apply_netem``, ``teardown``, ``NetnsRunner``, ``main``,
``bench_kill_stragglers``), over the port's ``RemoteBench``, node
parameters and ``faultline.Scenario``. Every ``ip``/``tc`` argv, flag and
printed line is the reference's, and the WAN or partition scenario goes to
the same file. What differs: ``main`` takes ``argv``; there is no
``sys.path`` edit; the repository is three directories up from this file.
The nodes verify under their default backend, ``cuda``, so each namespace
reaches the machine's card. Nothing is left out.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import time

BRIDGE = "hsbr0"
SUBNET = "10.99.0"
WORK_ROOT = "/tmp/hs-netns-hosts"
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def _run(cmd: list[str], check: bool = True, **kw):
    return subprocess.run(cmd, check=check, capture_output=True, text=True, **kw)


def host_ip(i: int) -> str:
    return f"{SUBNET}.{i + 1}"


def ns_name(ip: str) -> str:
    return "hs" + ip.rsplit(".", 1)[1]


def setup(n: int) -> list[str]:
    """Create the bridge and n namespaces; returns their IPs."""
    teardown()
    _run(["ip", "link", "add", BRIDGE, "type", "bridge"])
    _run(["ip", "addr", "add", f"{SUBNET}.254/24", "dev", BRIDGE])
    _run(["ip", "link", "set", BRIDGE, "up"])
    hosts = []
    for i in range(n):
        ip = host_ip(i)
        ns = ns_name(ip)
        veth = f"hsv{i}"
        _run(["ip", "netns", "add", ns])
        _run(
            ["ip", "link", "add", veth, "type", "veth", "peer", "name",
             "eth0", "netns", ns]
        )
        _run(["ip", "link", "set", veth, "master", BRIDGE])
        _run(["ip", "link", "set", veth, "up"])
        _run(["ip", "netns", "exec", ns, "ip", "addr", "add", f"{ip}/24",
              "dev", "eth0"])
        _run(["ip", "netns", "exec", ns, "ip", "link", "set", "eth0", "up"])
        _run(["ip", "netns", "exec", ns, "ip", "link", "set", "lo", "up"])
        hosts.append(ip)
    return hosts


def apply_netem(
    hosts: list[str], rtt_ms: float, jitter_ms: float = 0.0,
    loss_pct: float = 0.0,
) -> bool:
    """WAN shaping: attach ``tc netem`` to every namespace's egress.
    Each side delays its own egress by rtt/2, so any A<->B round trip
    pays the full RTT — the standard symmetric-WAN emulation. Loss is
    per-direction. Returns False when the kernel lacks ``sch_netem``
    (container kernels often do) — the caller then falls back to
    faultline's app-layer link delay."""
    if rtt_ms <= 0 and loss_pct <= 0:
        return True
    for ip in hosts:
        ns = ns_name(ip)
        cmd = ["ip", "netns", "exec", ns, "tc", "qdisc", "add", "dev",
               "eth0", "root", "netem"]
        if rtt_ms > 0:
            cmd += ["delay", f"{rtt_ms / 2:.1f}ms"]
            if jitter_ms > 0:
                cmd += [f"{jitter_ms / 2:.1f}ms"]
        if loss_pct > 0:
            cmd += ["loss", f"{loss_pct}%"]
        res = _run(cmd, check=False)
        if res.returncode != 0:
            print(
                f"tc netem unavailable ({res.stderr.strip() or 'unknown'}); "
                "falling back to faultline app-layer WAN shaping"
            )
            return False
    return True


def teardown() -> None:
    out = _run(["ip", "netns", "list"], check=False).stdout
    for line in out.splitlines():
        name = line.split()[0] if line.split() else ""
        if name.startswith("hs"):
            _run(["ip", "netns", "del", name], check=False)
    _run(["ip", "link", "del", BRIDGE], check=False)


class NetnsRunner:
    """``RemoteBench`` transport backed by ``ip netns exec``.

    Each host's commands run inside its namespace with HOME and CWD set
    to a private per-host directory, so ``~``-relative paths and process
    match patterns (``pkill -f``) naturally scope per host even though
    all hosts share one pid namespace.
    """

    def __init__(self, repo_path: str | None = None) -> None:
        self.repo_path = repo_path or REPO_ROOT

    def _home(self, host: str) -> str:
        return os.path.join(WORK_ROOT, host)

    def exec(self, host: str, command: str, check: bool = True):
        home = self._home(host)
        os.makedirs(home, exist_ok=True)
        env = dict(os.environ, HOME=home)
        return subprocess.run(
            ["ip", "netns", "exec", ns_name(host), "bash", "-c", command],
            check=check,
            capture_output=True,
            text=True,
            cwd=home,
            env=env,
        )

    def _map(self, host: str, remote: str) -> str:
        if remote.startswith("~"):
            remote = self._home(host) + remote[1:]
        if not os.path.isabs(remote):
            remote = os.path.join(self._home(host), remote)
        return remote

    def put(self, host: str, local: str, remote: str) -> None:
        dst = self._map(host, remote)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copy(local, dst)

    def get(self, host: str, remote: str, local: str) -> None:
        shutil.copy(self._map(host, remote), local)

    def provision(self, host: str) -> None:
        """Real clone per host (the install step, sans apt: the base
        image is the machine we are on)."""
        home = self._home(host)
        os.makedirs(home, exist_ok=True)
        repo_name = os.path.basename(self.repo_path.rstrip("/")) or "repo"
        dst = os.path.join(home, repo_name)
        if not os.path.isdir(os.path.join(dst, ".git")):
            _run(["git", "clone", "--depth", "1",
                  f"file://{self.repo_path}", dst])


def main(argv=None) -> None:
    from hotstuff_tpu_torch.benchmark.remote import RemoteBench
    from hotstuff_tpu_torch.benchmark.settings import Settings

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--hosts", type=int, default=4)
    p.add_argument("--rate", type=int, default=1_000)
    p.add_argument("--tx-size", type=int, default=512)
    p.add_argument("--duration", type=int, default=20)
    p.add_argument("--faults", type=int, default=0)
    p.add_argument("--timeout", type=int, default=5_000)
    p.add_argument(
        "--rtt", type=float, default=0.0,
        help="tc netem WAN shaping: full round-trip time in ms between "
        "any two hosts (each namespace delays its egress by rtt/2)",
    )
    p.add_argument(
        "--jitter", type=float, default=0.0,
        help="tc netem delay jitter in ms (full-RTT scale, split per side)",
    )
    p.add_argument(
        "--loss", type=float, default=0.0,
        help="tc netem per-direction packet loss percentage",
    )
    p.add_argument(
        "--partition", metavar="GROUPS",
        help="partition mode: host-index groups separated by '|' (e.g. "
        "'0,1|2,3'), cut at --partition-at and healed at "
        "--partition-heal seconds into the run. Enacted by each node's "
        "env-armed faultline plane (scheduled, deterministic, and "
        "kernel-agnostic — unlike tc, which cannot time a cut)",
    )
    p.add_argument(
        "--partition-at", type=float, default=5.0,
        help="seconds into the run the partition cuts (with --partition)",
    )
    p.add_argument(
        "--partition-heal", type=float, default=10.0,
        help="seconds into the run the partition heals (with --partition)",
    )
    p.add_argument("--output", help="directory to append the SUMMARY to")
    p.add_argument("--keep", action="store_true", help="skip teardown")
    args = p.parse_args(argv)

    repo = REPO_ROOT
    repo_name = os.path.basename(repo.rstrip("/")) or "repo"
    settings = Settings(
        testbed="netns",
        key_name="-",
        key_path="-",
        consensus_port=8000,
        mempool_port=7000,
        front_port=6000,
        repo_name=repo_name,
        repo_url=f"file://{repo}",
        branch="main",
        instance_type="-",
        aws_regions=[],
    )

    hosts = setup(args.hosts)
    netem_ok = apply_netem(hosts, args.rtt, args.jitter, args.loss)
    events: list[dict] = []
    if not netem_ok and (args.rtt > 0 or args.loss > 0):
        # Kernel without sch_netem: emulate the WAN in the nodes
        # themselves via a permanent faultline all-links rule (each
        # side delays its egress by rtt/2; loss maps to per-frame drop).
        events.append(
            {
                "kind": "link",
                "src": "*",
                "dst": "*",
                "at": 0.0,
                "delay_ms": [args.rtt / 2, args.rtt / 2 + args.jitter / 2],
                "drop": args.loss / 100.0,
            }
        )
    if args.partition:
        # Partition mode: host-index groups (committee node names are
        # positional — n000… in consensus-address order, which setup()
        # makes identical to host order).
        groups = [
            [int(x) for x in group.split(",") if x != ""]
            for group in args.partition.split("|")
        ]
        events.append(
            {
                "kind": "partition",
                "groups": groups,
                "at": args.partition_at,
                "until": args.partition_heal,
            }
        )
    node_env = ""
    if events:
        from hotstuff_tpu_torch.faultline import Scenario

        label = f"wan-rtt{int(args.rtt)}" if args.rtt else "partition"
        chaos = Scenario(
            name=f"netns-{label}",
            seed=0,
            duration_s=float(args.duration + 3600),
            events=events,
        )
        wan_file = "/tmp/hs-netns-wan.json"
        chaos.save(wan_file)
        node_env = "HOTSTUFF_FAULTLINE=~/bench/chaos.json"
    try:
        from hotstuff_tpu_torch.consensus import Parameters as CParams
        from hotstuff_tpu_torch.mempool import Parameters as MParams
        from hotstuff_tpu_torch.node.config import Parameters as NodeParams

        bench = RemoteBench(settings, hosts, runner=NetnsRunner(repo))
        bench.install()
        bench.config(
            node_params=NodeParams(
                CParams(timeout_delay=args.timeout), MParams()
            )
        )
        if node_env:
            for host in hosts:
                bench.runner.put(host, "/tmp/hs-netns-wan.json", "bench/chaos.json")
        parser = bench.run(
            rate=args.rate,
            tx_size=args.tx_size,
            duration=args.duration,
            faults=args.faults,
            timeout_delay=args.timeout,
            node_env=node_env,
        )
        summary = parser.result()
        print(summary)
        if args.output:
            os.makedirs(args.output, exist_ok=True)
            shaped = f"-rtt{int(args.rtt)}" if args.rtt else ""
            if args.partition:
                shaped += "-part"
            name = (
                f"remote-netns{shaped}-{args.faults}-{args.hosts}-"
                f"{args.rate}-{args.tx_size}.txt"
            )
            with open(os.path.join(args.output, name), "a") as f:
                if args.rtt or args.loss:
                    f.write(
                        f"netem: rtt={args.rtt}ms jitter={args.jitter}ms "
                        f"loss={args.loss}%\n"
                    )
                if args.partition:
                    f.write(
                        f"partition: {args.partition} cut at "
                        f"{args.partition_at}s healed at "
                        f"{args.partition_heal}s\n"
                    )
                f.write(summary + "\n")
    finally:
        if not args.keep:
            bench_kill_stragglers()
            teardown()


def bench_kill_stragglers() -> None:
    _run(["pkill", "-f", WORK_ROOT], check=False)
    time.sleep(0.5)


if __name__ == "__main__":
    main()
