"""Faultline's injection points, kept import-light on purpose.

The network plane (``network/receiver.py``, ``simple_sender.py``,
``reliable_sender.py``; the native transport's wrapper, when it is
ported) imports THIS module only — never the scenario/runtime
machinery — so the disabled-path cost is one module-global load per
send/receive and the network package acquires no new import-time
dependencies.

``plane`` is the process's active :class:`~.runtime.FaultPlane` (None
when faultline is off — the overwhelmingly common case). ``NODE`` is the
sender identity: a contextvar so one process can host a whole committee
(each engine's actor tasks are spawned under its own value; tasks
inherit the context they were created in), with an env-var default for
one-node-per-process deployments (``HOTSTUFF_FAULTLINE_NODE``).

Port copy of ``hotstuff_tpu/faultline/hooks.py``. The two packages keep
separate ``plane`` globals: a plane installed in one never filters the
other's senders.
"""

from __future__ import annotations

import contextvars
import os

#: the active FaultPlane, or None (fast path). Set via runtime.install().
plane = None

#: sender identity for link resolution; see module docstring.
NODE: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "faultline_node", default=os.environ.get("HOTSTUFF_FAULTLINE_NODE")
)


def current_node() -> str | None:
    return NODE.get()


def active():
    """The installed plane, or None."""
    return plane
