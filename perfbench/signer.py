"""Signing worker of the input generator: reads a pickled list of
``(a, prefix, public key, message)`` on standard input and writes the
pickled list of their RFC 8032 signatures on standard output. Runs as
``python3 -m perfbench.signer``; imports nothing of the program and no
third-party module, so a worker starts in a fraction of a second."""

from __future__ import annotations

import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from perfbench.reference import ed25519


def sign_all(items: list, workers: int, cwd) -> list[bytes]:
    """Signatures of ``items``, spread over ``workers`` processes."""
    if not items:
        return []
    size = -(-len(items) // workers)
    chunks = [items[i : i + size] for i in range(0, len(items), size)]
    procs = [subprocess.Popen([sys.executable, "-m", "perfbench.signer"], cwd=cwd,
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE)
             for _ in chunks]
    try:
        with ThreadPoolExecutor(len(procs)) as pool:
            outs = list(pool.map(lambda pc: pc[0].communicate(pickle.dumps(pc[1]))[0],
                                 zip(procs, chunks)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError("a signing worker failed")
    sigs = []
    for out in outs:
        sigs.extend(pickle.loads(out))  # our own worker's output
    return sigs


if __name__ == "__main__":
    pickle.dump(ed25519.sign_many(pickle.load(sys.stdin.buffer)), sys.stdout.buffer)
