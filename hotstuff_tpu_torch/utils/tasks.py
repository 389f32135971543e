"""Actor-task lifecycle helpers.

Port copy of ``hotstuff_tpu/utils/tasks.py``, whole.

Every long-lived actor task should attach :func:`log_task_death` so an
unhandled exception is surfaced loudly instead of vanishing into an
un-awaited task (the asyncio analog of the reference's panic-on-join
behavior for crashed tokio tasks).
"""

from __future__ import annotations

import asyncio
import logging

log = logging.getLogger("hotstuff")


def log_task_death(task: asyncio.Task) -> None:
    """Done-callback: surface unexpected actor-task death."""
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        log.critical(
            "task %s died: %s: %s", task.get_name(), type(exc).__name__, exc
        )
