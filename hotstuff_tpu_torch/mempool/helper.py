"""Mempool helper: serve peers' ``BatchRequest``s from the store (reference
``mempool/src/helper.rs:25-66``).

Port copy of ``hotstuff_tpu/mempool/helper.py``, whole. The stored value is
the full serialized ``Batch`` message, so it is sent back raw and flows the
peer's normal batch-reception path."""

from __future__ import annotations

import asyncio
import logging

from hotstuff_tpu_torch.network import SimpleSender
from hotstuff_tpu_torch.store import Store

from .config import Committee

log = logging.getLogger("mempool")


class Helper:
    @classmethod
    def spawn(
        cls, committee: Committee, store: Store, rx_request: asyncio.Queue
    ) -> asyncio.Task:
        network = SimpleSender()

        async def run():
            while True:
                digests, origin = await rx_request.get()
                address = committee.mempool_address(origin)
                if address is None:
                    log.warning("received batch request from unknown node %s", origin)
                    continue
                for digest in digests:
                    batch = await store.read(digest.data)
                    if batch is not None:
                        network.send(address, batch)

        return asyncio.create_task(run(), name="mempool_helper")
