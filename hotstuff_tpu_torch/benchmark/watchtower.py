"""Port copy of the reference's ``benchmark/watchtower.py``, whole
(``DirectoryWatch``, ``replay``, the CLI), over the port's ``logs`` and
``hotstuff_tpu_torch/telemetry/watchtower.py``. Nothing is left out.

Live watchtower: tail the telemetry streams of a running committee,
score every peer, and fire alerts WHILE the run is going.

    # live: follow a local bench's logs directory until Ctrl-C
    python -m hotstuff_tpu_torch.benchmark.watchtower .bench/logs --capture .bench/captures

    # replay: analyze finished streams (same code path, no tailing)
    python -m hotstuff_tpu_torch.benchmark.watchtower results-run/logs --once

Per stream file this multiplexes a :class:`hotstuff_tpu_torch.benchmark.logs.StreamFollower`
(tail-follow with partial-line and truncation handling) into one
:class:`hotstuff_tpu_torch.telemetry.Watchtower`; new ``telemetry-*.jsonl``
files appearing mid-run (a node booting late, a restart) are picked up
by periodic rescans. Alerts print as they fire and are appended to
``watchtower-alerts.jsonl`` (one ``hotstuff-alert-v1`` line each) next
to the streams — machine-consumable by the soak verdict and the
detector bench. ``--capture DIR`` arms :class:`AlertCapture`.

:class:`DirectoryWatch` is the embeddable form — ``benchmark/soak.py``
runs one in a thread for the live soak verdict, and
``benchmark/watchtower_smoke.py`` measures its attached overhead.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import threading
import time

from hotstuff_tpu_torch.benchmark.logs import StreamFollower
from hotstuff_tpu_torch.telemetry import watchtower as wt_mod


class DirectoryWatch(threading.Thread):
    """Follow every ``telemetry-*.jsonl`` in a directory through one
    Watchtower. Start it, run the workload, then ``stop()`` (which
    performs a final drain + flush so end-of-run evidence is judged).

    The thread is the single ingest writer; ``alerts()`` /
    ``scoreboard()`` are safe to call from other threads at any time.
    """

    def __init__(
        self,
        directory: str,
        *,
        config: wt_mod.WatchtowerConfig | None = None,
        alias: dict[str, str] | None = None,
        on_alert=None,
        alerts_path: str | None = None,
        pattern: str = "telemetry-*.jsonl",
        poll_s: float = 0.2,
        rescan_s: float = 1.0,
        tick_with_wall_clock: bool = True,
    ) -> None:
        super().__init__(name="watchtower", daemon=True)
        self.directory = directory
        self.pattern = pattern
        self.poll_s = poll_s
        self.rescan_s = rescan_s
        self.alerts_path = alerts_path
        self.tick_with_wall_clock = tick_with_wall_clock
        self._stop_evt = threading.Event()
        self._followers: dict[str, StreamFollower] = {}
        self.watch = wt_mod.Watchtower(
            config, alias=alias, on_alert=self._on_alert, label="watchtower"
        )
        self._user_on_alert = on_alert
        self._alerts_fh = None

    # -- alert sink ----------------------------------------------------------

    def _on_alert(self, alert: dict) -> None:
        if self.alerts_path is not None:
            try:
                if self._alerts_fh is None:
                    os.makedirs(
                        os.path.dirname(os.path.abspath(self.alerts_path)),
                        exist_ok=True,
                    )
                    self._alerts_fh = open(self.alerts_path, "a")
                self._alerts_fh.write(
                    json.dumps(alert, separators=(",", ":")) + "\n"
                )
                self._alerts_fh.flush()
            except OSError:
                pass  # monitoring must not die on a full disk
        if self._user_on_alert is not None:
            self._user_on_alert(alert)

    # -- lifecycle -----------------------------------------------------------

    def _rescan(self) -> None:
        for path in sorted(
            glob.glob(os.path.join(self.directory, self.pattern))
        ):
            if path not in self._followers:
                self._followers[path] = StreamFollower(
                    path, poll_s=self.poll_s
                )

    def _drain_all(self) -> int:
        # One feed() per stream: the batch path the replay/sweep planes
        # use, so live-follow and offline replay share the ingest loop.
        n = 0
        for path, follower in self._followers.items():
            batch = [(record, path) for record in follower.drain()]
            if batch:
                self.watch.feed(batch)
                n += len(batch)
        return n

    def run(self) -> None:
        last_rescan = 0.0
        while not self._stop_evt.is_set():
            now = time.time()
            if now - last_rescan >= self.rescan_s:
                self._rescan()
                last_rescan = now
            got = self._drain_all()
            if self.tick_with_wall_clock:
                self.watch.tick(time.time())
            else:
                self.watch.tick()
            if not got:
                self._stop_evt.wait(self.poll_s)
        # Final sweep: records written between the last poll and stop()
        # (teardown flushes the final snapshot + trace tail).
        self._rescan()
        self._drain_all()
        self.watch.flush()
        if self._alerts_fh is not None:
            self._alerts_fh.close()
            self._alerts_fh = None

    def stop(self, join_timeout_s: float = 10.0) -> None:
        self._stop_evt.set()
        if self.is_alive():
            self.join(join_timeout_s)

    # -- read side -----------------------------------------------------------

    def alerts(self) -> list[dict]:
        return self.watch.snapshot_alerts()

    def scoreboard(self) -> dict:
        return self.watch.scoreboard()

    def stats(self) -> dict:
        return {
            "streams": len(self._followers),
            "records": sum(
                f.records_read for f in self._followers.values()
            ),
            "skipped": sum(f.skipped for f in self._followers.values()),
            "truncations": sum(
                f.truncations for f in self._followers.values()
            ),
        }


def replay_directory(
    directory: str,
    *,
    config: wt_mod.WatchtowerConfig | None = None,
    alias: dict[str, str] | None = None,
    on_alert=None,
    pattern: str = "telemetry-*.jsonl",
) -> wt_mod.Watchtower:
    """Post-hoc analysis of finished streams through the SAME incremental
    ingest path the live follower uses (the replay = live equivalence the
    detector bench leans on). Records are globally ordered by wall time
    so cross-stream windows close the way they would have live."""
    watch = wt_mod.Watchtower(
        config, alias=alias, on_alert=on_alert, label="watchtower-replay"
    )
    timed: list[tuple[float, str, dict]] = []
    for path in sorted(glob.glob(os.path.join(directory, pattern))):
        follower = StreamFollower(path)
        anchor_off = None
        for record in follower.drain():
            schema = record.get("schema")
            ts = record.get("ts")
            if schema == "hotstuff-trace-v1":
                anchor = record.get("anchor") or {}
                if all(
                    isinstance(anchor.get(k), (int, float))
                    for k in ("mono", "wall")
                ):
                    anchor_off = anchor["wall"] - anchor["mono"]
                events = record.get("events") or ()
                if events and anchor_off is not None:
                    ts = events[0][4] + anchor_off
            if not isinstance(ts, (int, float)):
                ts = timed[-1][0] if timed else 0.0
            timed.append((ts, path, record))
    timed.sort(key=lambda x: x[0])
    watch.feed((record, path) for _ts, path, record in timed)
    watch.flush()
    return watch


def _fmt_alert(alert: dict) -> str:
    rounds = alert["window"].get("rounds")
    return (
        f"[watchtower] {alert['detector']}: accused={alert['accused']} "
        f"confidence={alert['confidence']}"
        + (f" rounds={rounds}" if rounds else "")
        + f" evidence={json.dumps(alert['evidence'], sort_keys=True)}"
    )


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "directory", help="directory containing telemetry-*.jsonl streams"
    )
    p.add_argument(
        "--once", action="store_true",
        help="replay the existing streams and exit (no tailing)",
    )
    p.add_argument(
        "--duration", type=float, default=None,
        help="follow for this many seconds, then report (default: Ctrl-C)",
    )
    p.add_argument(
        "--config", help="JSON file of WatchtowerConfig overrides"
    )
    p.add_argument(
        "--capture", metavar="DIR",
        help="arm alert-triggered capture (evidence + flight + bounded "
        "profile) into DIR",
    )
    p.add_argument(
        "--alerts-file", default=None,
        help="append hotstuff-alert-v1 lines here (default: "
        "<directory>/watchtower-alerts.jsonl)",
    )
    p.add_argument(
        "--scoreboard", action="store_true",
        help="print the per-peer scoreboard at exit",
    )
    args = p.parse_args()

    config = None
    if args.config:
        with open(args.config) as f:
            config = wt_mod.WatchtowerConfig.from_dict(json.load(f))

    capture = None
    if args.capture:
        capture = wt_mod.AlertCapture(args.capture)

    def on_alert(alert: dict) -> None:
        if capture is not None:
            capture(alert)
        print(_fmt_alert(alert), flush=True)

    if args.once:
        watch = replay_directory(
            args.directory, config=config, on_alert=on_alert
        )
        alerts = watch.snapshot_alerts()
        board = watch.scoreboard()
    else:
        alerts_path = args.alerts_file or os.path.join(
            args.directory, "watchtower-alerts.jsonl"
        )
        dw = DirectoryWatch(
            args.directory,
            config=config,
            on_alert=on_alert,
            alerts_path=alerts_path,
        )
        if capture is not None:
            # In-process capture gets the live trace ring + registry only
            # when the watcher shares the node process; a standalone
            # follower captures evidence windows.
            capture.watchtower = dw.watch
        dw.start()
        try:
            if args.duration is not None:
                time.sleep(args.duration)
            else:
                while True:
                    time.sleep(3600)
        except KeyboardInterrupt:
            pass
        dw.stop()
        alerts = dw.alerts()
        board = dw.scoreboard()
        print(f"[watchtower] streams: {json.dumps(dw.stats())}")

    print(
        f"[watchtower] {len(alerts)} alert(s); frontier={board['frontier']} "
        f"over {board['rounds']} scored round(s)"
    )
    if args.scoreboard:
        print(json.dumps(board, indent=2, sort_keys=True))
    sys.exit(0 if not alerts else 3)


if __name__ == "__main__":
    main()
