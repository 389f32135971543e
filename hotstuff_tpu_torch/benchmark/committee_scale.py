"""Committee-scale consensus benchmark (BASELINE.json configs 2-4), on the
port.

Port copy of the reference's ``benchmark/committee_scale.py``, every mode
and flag, over the port's consensus, crypto, store, faultline, engine
groups, network and telemetry. Its flags, printed lines and result-file
names are the reference's, but ``--profile``'s table, which bills the
certificate path's stage spans (``telemetry/stages.py``) beside the core's
handler stages. The backend is the port's
(``HOTSTUFF_CRYPTO_BACKEND``: ``cuda``, the default, ``cuda-batched``,
``cpu``, ``cpu-batched``), so a run that does not name ``cpu`` runs on the
card and raises without one. ``--mode crypto`` calls ``Block.verify``
outside any event loop: the QC and TC batches go straight to the active
backend (``crypto.backend_verify_batch``), not through the consensus
crypto bridge. ``transport=`` is read from the network package's
``Receiver``, which under ``HOTSTUFF_NET=native`` is the C++ engine's or
the import raised. Nothing is left out. On the H100 host pass a
``--base-port`` below 16000, since the default 17000 lies inside its
ephemeral range.

Two modes:

``--mode protocol`` (default) boots an N-validator committee of full
consensus engines IN ONE PROCESS over real localhost TCP (mempool channels
sunk, like the reference's `node deploy` testbed) with
``batch_vote_verification`` on, and measures round rate under the selected
crypto backend. Socket count scales as N^2, so this mode tops out around
N=100 on one host.

``--mode crypto`` measures the per-round *certificate verification* load at
committees where the protocol cannot be materialized on one box (N=400,
N=1000 — BASELINE configs 3-4): each round verifies one proposal the way a
validator does (block signature + embedded 2f+1-vote QC batch verification,
``consensus/messages.py`` — the same code the node runs), and with
``--tc-heavy`` additionally verifies a (2f+1)-signature TimeoutCertificate
per round (the f=333 view-change regime; reference ``messages.rs:283-320``).

    python -m hotstuff_tpu_torch.benchmark.committee_scale --nodes 20 --rounds 20 \
        --base-port 14100
    HOTSTUFF_CRYPTO_BACKEND=cuda python -m hotstuff_tpu_torch.benchmark.committee_scale \
        --nodes 1000 --mode crypto --tc-heavy --output results

Results are appended to ``<output>/committee-<mode>[-tc]-<backend>-<N>.txt``
when ``--output`` is given.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys
import time

from hotstuff_tpu_torch.benchmark.hostinfo import host_meta


async def run_committee(
    n: int,
    rounds_target: int,
    base_port: int,
    timeout_delay: int,
    profile: bool = False,
    telemetry_path: str | None = None,
    profiler=None,
):
    """Returns ``(seconds_per_round, stage_profile | None)`` where the
    stage profile — measured-window deltas of the registry's
    ``consensus.stage.<kind>.{ns,calls}`` counters — covers EVERY
    engine's core (the whole committee's per-round handler cost), and
    the certificate path's stage spans (``crypto.*``, ``consensus.decode``)
    under their names."""
    from hotstuff_tpu_torch import telemetry
    from hotstuff_tpu_torch.consensus import Authority, Committee, Consensus, Parameters
    from hotstuff_tpu_torch.telemetry import stages
    from hotstuff_tpu_torch.crypto import SignatureService, generate_keypair
    from hotstuff_tpu_torch.store import Store

    emitter = None
    if telemetry_path:
        emitter = telemetry.TelemetryEmitter(
            telemetry.get_registry(),
            telemetry_path,
            node=f"committee-{n}",
            interval_s=telemetry.env_interval_s(),
            # Cross-node trace events ride the same stream: every
            # engine's RoundTrace labels its events with its key, so one
            # in-process stream carries the whole committee's timelines
            # (benchmark/trace_assemble.py here merges them per round).
            trace=telemetry.trace_buffer(),
            # --pyprof: folded-stack profile records interleave too
            # (benchmark/profile_assemble.py here joins them onto the edges).
            profiler=profiler,
        )

    keys = [generate_keypair() for _ in range(n)]
    committee = Committee(
        authorities={
            pk: Authority(stake=1, address=("127.0.0.1", base_port + i))
            for i, (pk, _) in enumerate(keys)
        }
    )
    params = Parameters(
        timeout_delay=timeout_delay, batch_vote_verification=True
    )

    engines, commits, sinks = [], [], []
    for pk, sk in keys:
        rx_mempool: asyncio.Queue = asyncio.Queue()
        tx_mempool: asyncio.Queue = asyncio.Queue()
        tx_commit: asyncio.Queue = asyncio.Queue()

        async def drain(q=tx_mempool):
            while True:
                await q.get()

        sinks.append(asyncio.create_task(drain()))
        engines.append(
            await Consensus.spawn(
                pk,
                committee,
                params,
                SignatureService(sk),
                Store(),
                rx_mempool,
                tx_mempool,
                tx_commit,
                profile=profile,
            )
        )
        commits.append(tx_commit)

    # Wait for the first commit everywhere, then time rounds_target more.
    await asyncio.gather(*[q.get() for q in commits])
    if emitter is not None:
        # Stream from the measurement anchor, not process start: the N^2
        # dial-in boot phase would otherwise dominate the stream with
        # zero-progress windows and boot-skew timeouts, and SLO verdicts
        # must judge the measured regime (boot counters still appear —
        # cumulatively — in the first snapshot's totals, just never as a
        # window delta).
        #
        # The round-trace ring gets the same anchoring: boot-era events
        # would otherwise drain into the measured stream, and a round
        # whose timeline spans both lives (proposed during dial-in,
        # commit-straggled by a lagging engine into the measured window)
        # reports a multi-minute "critical path" that is really boot
        # skew — observed live at N=200, poisoning the committed
        # trace-edge means by two orders of magnitude.
        telemetry.trace_buffer().clear()
        emitter.emit()
        emitter.spawn()
    registry = telemetry.get_registry()
    warmup = registry.snapshot()["counters"] if profile else None
    if profile:
        # The certificate path's own stages (telemetry/stages.py) bill
        # beside the handlers, under their span names.
        stages.arm()
    t0 = time.perf_counter()
    try:
        for _ in range(rounds_target):
            await asyncio.gather(*[q.get() for q in commits])
        elapsed = time.perf_counter() - t0
    finally:
        if profile:
            stages.disarm()

    stage_profile: dict[str, tuple[int, int]] | None = None
    if profile:
        # Measured-window deltas only (warm-up handlers excluded).
        deltas = telemetry.diff_counters(warmup, registry.snapshot()["counters"])
        stage_profile = {}
        prefix = "consensus.stage."
        for name, value in deltas.items():
            if name.startswith(prefix):
                kind, field = name[len(prefix):].rsplit(".", 1)
            elif name.rsplit(".", 1)[0] in stages.NESTING:
                kind, field = name.rsplit(".", 1)
            else:
                continue
            ns, calls = stage_profile.get(kind, (0, 0))
            if field == "ns":
                ns += value
            elif field == "calls":
                calls += value
            stage_profile[kind] = (ns, calls)

    if emitter is not None:
        await emitter.shutdown()
    for e in engines:
        await e.shutdown()
    for s in sinks:
        s.cancel()
    return elapsed / rounds_target, stage_profile


def run_crypto_rounds(n: int, rounds: int, tc_heavy: bool) -> float:
    """Per-round certificate-verification time at committee size n: one
    proposal verification (block sig + QC batch over 2f+1 votes) and, with
    ``tc_heavy``, one (2f+1)-vote TC verification — the exact
    ``Block.verify``/``TC.verify`` code paths a validator runs per round."""
    import struct

    from hotstuff_tpu_torch.consensus import Authority, Committee
    from hotstuff_tpu_torch.consensus.messages import QC, TC, Block
    from hotstuff_tpu_torch.crypto import Signature, generate_keypair, sha512_digest

    keys = [generate_keypair() for _ in range(n)]
    committee = Committee(
        authorities={
            pk: Authority(stake=1, address=("127.0.0.1", 0))
            for pk, _ in keys
        }
    )
    f = (n - 1) // 3
    quorum = 2 * f + 1

    # Genesis-parented block signed by the round-2 leader, with a real QC
    # over round 1 and (optionally) a TC for the view change into round 2.
    genesis = Block.genesis()
    qc = QC(hash=genesis.digest(), round=1, votes=[])
    qc.votes = [
        (pk, Signature.new(qc.digest(), sk)) for pk, sk in keys[:quorum]
    ]

    tc = None
    if tc_heavy:
        u64 = struct.Struct("<Q")
        tc_votes = [
            (pk, Signature.new(sha512_digest(u64.pack(2), u64.pack(1)), sk), 1)
            for pk, sk in keys[:quorum]
        ]
        tc = TC(round=2, votes=tc_votes)

    author_pk, author_sk = keys[0]
    block = Block.new_from_key(
        qc=qc, tc=tc, author=author_pk, round_=2, payload=[], secret=author_sk
    )

    block.verify(committee)  # warm-up (kernel library load, key cache insert)
    t0 = time.perf_counter()
    for _ in range(rounds):
        block.verify(committee)
    return (time.perf_counter() - t0) / rounds


def run_faults(args) -> None:
    """``--faults``: run a faultline scenario end-to-end on the
    in-process committee and gate on the checker verdict. The scenario is
    a JSON file or the ``chaos:<seed>`` shorthand; with ``--replay`` the
    scenario runs TWICE and the two compiled fault schedules must be
    byte-identical (the seed-reproducibility contract)."""
    import json

    from hotstuff_tpu_torch import telemetry
    from hotstuff_tpu_torch.faultline import Scenario, chaos_scenario, run_scenario

    telemetry.enable()  # faultline.* counters + RoundTrace annotations
    if args.faults.startswith("chaos:"):
        scenario = chaos_scenario(
            int(args.faults.split(":", 1)[1]), duration_s=args.faults_duration
        )
    elif args.faults == "split":
        # The view-change/recovery probe: cut the committee into two
        # EVEN halves (neither holds 2f+1) for the middle 30% of the
        # run. All progress stops, both sides burn timeout rounds; on
        # heal the committee must timeout-sync, re-elect, and resume —
        # the verdict's liveness.recovery_s IS the measured view-change
        # + recovery cost.
        d = args.faults_duration
        half = args.nodes // 2
        scenario = Scenario(
            name="split",
            seed=0,
            duration_s=d,
            events=[
                {
                    "kind": "partition",
                    "groups": [
                        list(range(half)), list(range(half, args.nodes))
                    ],
                    "at": round(0.3 * d, 3),
                    "until": round(0.6 * d, 3),
                }
            ],
        )
    else:
        scenario = Scenario.load(args.faults)

    async def one_run(base_port: int) -> dict:
        return await run_scenario(
            scenario,
            args.nodes,
            base_port=base_port,
            timeout_delay=args.timeout,
            leader_elector=args.leader_elector,
            retention_rounds=args.retention_rounds,
            # Committee-size-aware recovery bound: post-heal the whole
            # committee must timeout-sync and re-quorum; at N=100 that
            # is minutes of real work on one core, not the N=4 seconds.
            recovery_timeout_s=max(30.0, 1.2 * args.nodes),
        )

    result = asyncio.run(one_run(args.base_port))
    traces = [result["trace"]]
    if args.replay:
        replay = asyncio.run(one_run(args.base_port + args.nodes + 16))
        traces.append(replay["trace"])
        assert traces[0] == traces[1], "replay trace diverged for equal seeds"
        result["replay_verdict"] = replay["verdict"]
    verdict = result["verdict"]
    fault_counters = {
        k: v
        for k, v in result["telemetry"]["counters"].items()
        if k.startswith("faultline.")
    }
    report = {
        "verdict": verdict,
        "host": host_meta(),
        # None (not true) when --replay didn't run: absence of evidence.
        "replay_trace_match": (
            traces[0] == traces[1] if len(traces) == 2 else None
        ),
        "trace": json.loads(traces[0]),
        "faultline_counters": fault_counters,
    }
    frontier = verdict.get("frontier_availability")
    ok = (
        verdict["safety"]["ok"]
        and verdict["liveness"]["recovered"]
        and (frontier is None or frontier["ok"])
    )
    print(
        f"faultline scenario={scenario.name} seed={scenario.seed} "
        f"nodes={args.nodes}: safety={'ok' if verdict['safety']['ok'] else 'VIOLATED'} "
        f"liveness={'recovered' if verdict['liveness']['recovered'] else 'STALLED'} "
        + (
            f"frontier={'ok' if frontier['ok'] else 'UNSERVABLE'} "
            f"floors={frontier['floors']} "
            if frontier is not None
            else ""
        )
        + f"commits={verdict['commits']} "
        f"injections={verdict['injections']['counts']}"
    )
    if args.output:
        os.makedirs(args.output, exist_ok=True)
        path = os.path.join(
            args.output, f"chaos-{scenario.name}-{args.nodes}.json"
        )
        with open(path, "w") as out:
            json.dump(report, out, indent=2, sort_keys=True)
            out.write("\n")
        print(f"verdict written to {path}")
    if not ok:
        sys.exit(1)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nodes", type=int, default=20)
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--base-port", type=int, default=17000)
    p.add_argument("--timeout", type=int, default=30_000)
    p.add_argument("--mode", choices=["protocol", "crypto"], default="protocol")
    p.add_argument("--tc-heavy", action="store_true")
    p.add_argument(
        "--groups",
        type=int,
        default=None,
        help="protocol mode: shard the committee across this many worker "
        "processes (engine groups, hotstuff_tpu_torch/parallel/engine_groups.py). "
        "Default: HOTSTUFF_ENGINE_GROUPS (0 = single-process, the "
        "byte-identical classic path)",
    )
    p.add_argument(
        "--faults",
        metavar="SCENARIO",
        help="run a faultline scenario (a JSON file, chaos:<seed> for a "
        "seeded storm, or 'split' for the even two-way partition "
        "view-change probe) on the in-process committee and exit nonzero "
        "unless the checker reports safety=ok and liveness=recovered",
    )
    p.add_argument(
        "--faults-duration",
        type=float,
        default=15.0,
        help="chaos:<seed> scenario duration in virtual seconds",
    )
    p.add_argument(
        "--replay",
        action="store_true",
        help="with --faults: run the scenario twice and assert the two "
        "compiled fault schedules (replay traces) are identical",
    )
    p.add_argument(
        "--leader-elector",
        default="",
        help="with --faults: consensus leader elector (e.g. reputation)",
    )
    p.add_argument(
        "--retention-rounds",
        type=int,
        default=0,
        help="with --faults: arm snapshot/truncate log compaction at this "
        "retention depth (rounds; 0 = disabled) — the verdict then also "
        "gates on the frontier-availability invariant",
    )
    p.add_argument(
        "--profile",
        action="store_true",
        help="protocol mode: print per-stage µs/round (aggregated over "
        "every engine's core — the whole committee's per-round handler "
        "cost on this core; sourced from the telemetry registry's "
        "consensus.stage.* counters), with the certificate path's "
        "stage spans (telemetry/stages.py) armed over the window and "
        "billed beside them",
    )
    p.add_argument(
        "--telemetry",
        metavar="PATH",
        help="protocol mode: enable the telemetry plane and stream "
        "JSON-lines snapshots + cross-node trace events to PATH (final "
        "snapshot at shutdown; interval via HOTSTUFF_TELEMETRY_INTERVAL)",
    )
    p.add_argument(
        "--pyprof",
        nargs="?",
        const=2.0,
        type=float,
        metavar="INTERVAL_MS",
        help="protocol mode: run the all-thread sampling profiler for "
        "the whole run (default 2 ms). With --telemetry the folded-stack "
        "records ride the stream as hotstuff-profile-v1 lines and the "
        "per-edge function attribution is printed after the run "
        "(benchmark/profile_assemble.py joins them onto the trace "
        "edges); without it the top self-time functions are printed.",
    )
    p.add_argument(
        "--slo",
        nargs="?",
        const="default",
        metavar="SPEC.json",
        help="with --telemetry: evaluate SLOs over the emitted snapshot "
        "stream after the run (default spec set, or a JSON spec file) and "
        "exit nonzero on violation",
    )
    p.add_argument(
        "--watch",
        action="store_true",
        help="with --telemetry: attach the live watchtower (tail-follows "
        "the stream while the committee runs, scores every peer, prints "
        "hotstuff-alert-v1 alerts as they fire, and — in-process — dumps "
        "a flight record + bounded profile at the moment of detection)",
    )
    p.add_argument(
        "--watch-capture",
        metavar="DIR",
        help="with --watch: directory for alert-triggered captures "
        "(default: alongside the telemetry stream)",
    )
    p.add_argument("--output", help="directory to append the result file to")
    args = p.parse_args()

    if args.faults:
        # Chaos mode replaces the timing benchmark: a default --timeout
        # of 30 s would let a single dead-leader round eat the whole
        # scenario, so chaos runs use a snappier view-change budget.
        if args.timeout == 30_000:
            args.timeout = 1_000
        run_faults(args)
        return

    if args.telemetry or args.pyprof is not None:
        # BEFORE actors/backends are constructed: they capture their
        # metric objects at creation time. --pyprof needs this too: the
        # RoundTrace marks that drive the sampler's stage tags only
        # exist when telemetry is enabled.
        from hotstuff_tpu_torch import telemetry as _telemetry

        _telemetry.enable()

    profiler = None
    if args.pyprof is not None:
        if args.mode != "protocol":
            print("--pyprof requires --mode protocol", file=sys.stderr)
            sys.exit(2)
        from hotstuff_tpu_torch.telemetry import profiler as _pyprof

        profiler = _pyprof.SamplingProfiler(interval_ms=args.pyprof)
        profiler.start(mode="auto")

    if args.mode == "protocol":
        # The one-process committee multiplexes N engines' verification
        # requests through one crypto plane: enough bridge workers must
        # exist for concurrent requests to POOL in the superbatching
        # backend (fusion+dedup collapses the N byte-identical QC
        # verifies of a round to one MSM). With the default 2 workers the
        # pool depth is 2 and fusion never happens. Explicit env wins.
        os.environ.setdefault("HOTSTUFF_CRYPTO_WORKERS", "32")

    from hotstuff_tpu_torch.crypto import get_backend

    backend = get_backend().name
    f = (args.nodes - 1) // 3
    stage_profile = None
    watch = None
    if args.watch:
        if not args.telemetry or args.mode != "protocol":
            print(
                "--watch requires --mode protocol with --telemetry PATH",
                file=sys.stderr,
            )
            sys.exit(2)
        from hotstuff_tpu_torch.benchmark.watchtower import DirectoryWatch
        from hotstuff_tpu_torch import telemetry as _telemetry
        from hotstuff_tpu_torch.telemetry.watchtower import AlertCapture

        stream_abs = os.path.abspath(args.telemetry)
        capture = AlertCapture(
            args.watch_capture
            or os.path.join(os.path.dirname(stream_abs), "captures"),
            # In-process: the watcher shares the engines' process, so an
            # alert dumps the live trace ring + registry and runs a
            # bounded profiler burst on the spot.
            trace=_telemetry.trace_buffer(),
            registry=_telemetry.get_registry(),
        )
        watch = DirectoryWatch(
            os.path.dirname(stream_abs),
            pattern=os.path.basename(stream_abs),
            on_alert=capture,
            alerts_path=stream_abs + ".alerts.jsonl",
        )
        capture.watchtower = watch.watch
        watch.start()
    from hotstuff_tpu_torch.parallel.engine_groups import groups_from_env

    n_groups = args.groups if args.groups is not None else groups_from_env()
    if args.mode == "protocol" and n_groups >= 1:
        # Process-sharded committee: the parent only consumes decision
        # records from the groups' event rings (no engines, no crypto in
        # this process). Incompatible with the in-process observability
        # attachments (--profile/--telemetry/--pyprof/--watch), which
        # assume the engines share the parent's registry.
        if args.profile or args.telemetry or profiler is not None or watch:
            print(
                "--groups is incompatible with --profile/--telemetry/"
                "--pyprof/--watch (engines run in worker processes)",
                file=sys.stderr,
            )
            sys.exit(2)
        from hotstuff_tpu_torch.parallel.engine_groups import run_grouped_committee

        per_round, _merged = run_grouped_committee(
            args.nodes, args.rounds, n_groups,
            base_port=args.base_port, timeout_delay=args.timeout,
        )
    elif args.mode == "protocol":
        try:
            per_round, stage_profile = asyncio.run(
                run_committee(
                    args.nodes, args.rounds, args.base_port, args.timeout,
                    profile=args.profile,
                    telemetry_path=args.telemetry,
                    profiler=profiler,
                )
            )
        finally:
            if profiler is not None:
                profiler.stop()
            if watch is not None:
                watch.stop()
    else:
        per_round = run_crypto_rounds(args.nodes, args.rounds, args.tc_heavy)
    # Ask the network package what it ACTUALLY selected, so that result
    # lines never claim a transport that didn't run (the port's import
    # raises where the reference's falls back to asyncio).
    from hotstuff_tpu_torch import network as _network

    transport = (
        "native" if "Native" in _network.Receiver.__name__ else "asyncio"
    )
    line = (
        f"committee={args.nodes} (f={f}, QC size {2 * f + 1}) mode={args.mode}"
        f"{' tc-heavy' if args.tc_heavy else ''}"
        f"{f' groups={n_groups}' if args.mode == 'protocol' and n_groups else ''}"
        f" backend={backend}"
        f" transport={transport}: "
        f"{per_round * 1e3:.1f} ms/round ({1 / per_round:.2f} rounds/s)"
    )
    print(line)
    profile_lines = []
    if stage_profile:
        # Aggregated over ALL engines: the committee's whole per-round
        # handler bill on this core, by stage (telemetry registry,
        # consensus.stage.* counters over the measured window).
        profile_lines.append(
            f"per-stage handler cost (all {args.nodes} engines, "
            f"{args.rounds} measured rounds, telemetry registry):"
        )
        width = max(10, *map(len, stage_profile))
        profile_lines.append(
            f"  {'stage':<{width}} {'calls/round':>12} {'us/round':>12}"
        )
        for kind, (ns, calls) in sorted(
            stage_profile.items(), key=lambda kv: -kv[1][0]
        ):
            profile_lines.append(
                f"  {kind:<{width}} {calls / args.rounds:>12.1f} "
                f"{ns / 1e3 / args.rounds:>12.1f}"
            )
        print("\n".join(profile_lines))
    if args.output:
        os.makedirs(args.output, exist_ok=True)
        tag = f"{args.mode}{'-tc' if args.tc_heavy else ''}"
        path = os.path.join(
            args.output, f"committee-{tag}-{backend}-{args.nodes}.txt"
        )
        with open(path, "a") as out:
            out.write(line + "\n")
            for pl in profile_lines:
                out.write(pl + "\n")

    if profiler is not None:
        print(
            f"pyprof: {profiler.samples} samples @ {profiler.interval_ms} ms "
            f"({profiler.mode} mode), GIL delay "
            f"{profiler.gil_delay_ns / 1e6:.1f} ms"
        )
        if args.telemetry:
            # The emitter drained the folded stacks into the stream:
            # join them onto the trace edges for the printed answer.
            from hotstuff_tpu_torch.benchmark.profile_assemble import _human, attribute

            print(_human(attribute([args.telemetry])))
        else:
            self_c, cum_c, _samples = profiler.self_cum()
            total = sum(self_c.values())
            if total:
                print(f"{'SELF%':>6} {'CUM%':>6}  function")
                for fn, n in self_c.most_common(20):
                    print(
                        f"{100 * n / total:6.2f} {100 * cum_c[fn] / total:6.2f}"
                        f"  {fn}"
                    )

    if watch is not None:
        import json

        alerts = watch.alerts()
        board = watch.scoreboard()
        print(
            f"watchtower: {len(alerts)} alert(s), "
            f"frontier={board['frontier']}, "
            f"{board['rounds']} scored round(s), "
            f"streams={json.dumps(watch.stats())}"
        )
        for alert in alerts:
            print(
                f"  ALERT {alert['detector']}: accused={alert['accused']} "
                f"confidence={alert['confidence']} "
                f"capture={alert.get('capture', {})}"
            )

    if args.slo:
        if not args.telemetry:
            print("--slo requires --telemetry PATH", file=sys.stderr)
            sys.exit(2)
        import json

        from hotstuff_tpu_torch.benchmark.logs import read_telemetry_stream
        from hotstuff_tpu_torch.telemetry import slo as slo_mod

        specs = (
            slo_mod.default_slos()
            if args.slo == "default"
            else slo_mod.load_specs(args.slo)
        )
        verdict = slo_mod.evaluate(
            read_telemetry_stream(args.telemetry),
            specs,
            window_s=float(os.environ.get("HOTSTUFF_SLO_WINDOW_S", "30")),
            source=args.telemetry,
        )
        print(json.dumps(verdict, sort_keys=True))
        if not verdict["ok"]:
            print("SLO verdict: FAILED", file=sys.stderr)
            sys.exit(3)
        print("SLO verdict: ok")


if __name__ == "__main__":
    main()
