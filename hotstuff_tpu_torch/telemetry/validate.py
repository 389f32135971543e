"""Stream validation CLI: check any telemetry JSON-lines file against
every known record schema and print per-schema counts.

    python -m hotstuff_tpu_torch.telemetry.validate PATH [PATH ...]

Before this existed, a malformed stream was only diagnosed deep inside
the assemble scripts (a ParseError three layers into trace_assemble with
no hint which line was bad). This walks the file line by line, validates
each record against the schema its ``schema`` field claims, and reports:

- counts per schema (snapshots / traces / profiles / meta / alerts);
- every invalid line with its line number and the validator's problems;
- unknown-schema and non-JSON lines (a trailing truncated line — a
  writer killed mid-append — is reported but does not fail the file);
- whether the stream self-describes (a ``hotstuff-meta-v1`` record
  first, the contract every emitter follows since the meta record).

Exit code 0 when every file is clean, 1 when any problem was found.

Port copy of ``hotstuff_tpu/telemetry/validate.py``, alert records
included.
"""

from __future__ import annotations

import argparse
import json
import sys

from .dtrace import DTRACE_SCHEMA, validate_dtrace_record
from .emitter import META_SCHEMA, SCHEMA, validate_meta_record, validate_snapshot
from .profiler import PROFILE_SCHEMA, validate_profile_record
from .trace import TRACE_SCHEMA, validate_trace_record
from .watchtower import ALERT_SCHEMA, validate_alert_record

VALIDATORS = {
    SCHEMA: validate_snapshot,
    TRACE_SCHEMA: validate_trace_record,
    DTRACE_SCHEMA: validate_dtrace_record,
    PROFILE_SCHEMA: validate_profile_record,
    META_SCHEMA: validate_meta_record,
    ALERT_SCHEMA: validate_alert_record,
}


def validate_stream(path: str) -> dict:
    """Validate one stream file; returns the machine-readable report
    (``ok``, per-schema ``counts``, ``problems`` with line numbers)."""
    counts: dict[str, int] = {name: 0 for name in VALIDATORS}
    problems: list[dict] = []
    unknown = 0
    lines = 0
    truncated_tail = False
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        return {
            "path": path,
            "ok": False,
            "counts": counts,
            "lines": 0,
            "unknown_schema": 0,
            "truncated_tail": False,
            "problems": [{"line": 0, "problems": [str(e)]}],
        }
    payload = raw.split(b"\n")
    for i, line in enumerate(payload, 1):
        line = line.strip()
        if not line:
            continue
        lines += 1
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            if i == len(payload) and not raw.endswith(b"\n"):
                # The writer died mid-append: expected crash fallout.
                truncated_tail = True
                continue
            problems.append({"line": i, "problems": [f"bad JSON: {e}"]})
            continue
        schema = obj.get("schema") if isinstance(obj, dict) else None
        validator = VALIDATORS.get(schema)
        if validator is None:
            unknown += 1
            continue
        found = validator(obj)
        if found:
            problems.append({"line": i, "schema": schema, "problems": found})
        else:
            counts[schema] += 1
    return {
        "path": path,
        "ok": not problems,
        "lines": lines,
        "counts": counts,
        "unknown_schema": unknown,
        "truncated_tail": truncated_tail,
        "self_described": counts[META_SCHEMA] > 0,
        "problems": problems,
    }


def _human(report: dict) -> str:
    lines = [f"{report['path']}: {'ok' if report['ok'] else 'INVALID'}"]
    lines.append(
        "  "
        + "  ".join(
            f"{name.split('-')[1]}={n}"
            for name, n in sorted(report["counts"].items())
        )
        + f"  unknown={report['unknown_schema']}"
    )
    if not report.get("self_described"):
        lines.append(
            "  note: no hotstuff-meta-v1 record (pre-meta stream, or not "
            "written by a TelemetryEmitter)"
        )
    if report.get("truncated_tail"):
        lines.append("  note: truncated final line (writer died mid-append)")
    for p in report["problems"][:20]:
        lines.append(
            f"  line {p['line']}"
            + (f" [{p['schema']}]" if p.get("schema") else "")
            + ": " + "; ".join(p["problems"])
        )
    if len(report["problems"]) > 20:
        lines.append(f"  ... and {len(report['problems']) - 20} more")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m hotstuff_tpu_torch.telemetry.validate",
        description=__doc__,
    )
    p.add_argument("paths", nargs="+", help="stream files to validate")
    p.add_argument(
        "--json", action="store_true", help="machine-readable reports"
    )
    args = p.parse_args(argv)
    ok = True
    for path in args.paths:
        report = validate_stream(path)
        ok &= report["ok"]
        if args.json:
            print(json.dumps(report, sort_keys=True))
        else:
            print(_human(report))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
