"""Super-batching backend wrapper: fuse concurrent batch-verification
requests into one crypto call.

Port copy of ``hotstuff_tpu/crypto/batching.py``, less its telemetry
registry mirror (the counters stay as attributes). Individual QC/TC
verifications already batch their own 2f+1 signatures; this wrapper fuses
REQUESTS that arrive concurrently — QCs of pipelined rounds, proposals
verified while votes aggregate, the N copies of a rebroadcast certificate
— into one device dispatch.

Back-pressure batching, no timer: a request that arrives while the device
is idle flushes at once, and requests that arrive while an inner call is
in flight pool up and fuse into one call the moment it returns. Identical
(msg, pub, sig) triples dedup inside a flush, and concurrent verifies of
one certificate dedup by its key. If a fused batch fails, each request is
re-verified on its own, so one byzantine request cannot fail its
neighbours. A failure that is not a verdict (a device or runtime error)
reaches every waiter as ``BackendUnavailable``, never as acceptance.

The inner calls run on the flusher thread. In front of ``CudaBackend``
that thread launches the kernels; a fresh thread's current CUDA stream is
the default stream, which is the one ``CudaBackend`` uses from any thread.
"""

from __future__ import annotations

import threading

from . import (
    BackendUnavailable,
    CryptoError,
    _explode_cert,
    get_backend,
    set_backend,
)


class _Request:
    __slots__ = ("msgs", "pubs", "sigs", "cert", "done", "error")

    def __init__(self, msgs, pubs, sigs) -> None:
        self.msgs = msgs
        self.pubs = pubs
        self.sigs = sigs
        # Fused-cert requests carry (msgs, pubs, sig_buf, stride, key)
        # here and leave the triple lists empty.
        self.cert = None
        self.done = threading.Event()
        self.error: CryptoError | None = None


class BatchingBackend:
    """Wraps any backend; fuses concurrent ``verify_batch`` and
    ``verify_cert`` calls. Collection is driven by device back-pressure,
    not by a timer, so there is no window to set (the reference's
    ``window_ms`` is ignored there and left out here)."""

    def __init__(self, inner, max_sigs: int = 8192) -> None:
        self.inner = inner
        self.name = f"{inner.name}+superbatch"
        self.max_sigs = max_sigs
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: list[_Request] = []
        self._thread: threading.Thread | None = None
        # How many requests and inner calls, and how many signatures the
        # identical-triple and cert-key dedups removed.
        self.fused_requests = 0
        self.inner_calls = 0
        self.deduped_sigs = 0
        self.cert_requests = 0
        self.cert_deduped_sigs = 0

    def verify_batch(self, msgs, pubs, sigs) -> None:
        if not len(msgs) == len(pubs) == len(sigs):
            raise CryptoError("batch length mismatch")
        self._submit(_Request(list(msgs), list(pubs), list(sigs)))

    def verify_cert(self, msgs, pubs, sig_buf, stride: int = 64, key=None) -> None:
        """Fused certificate verification through the same pool: concurrent
        verifies of the SAME cert dedup by its identity to one inner call.
        ``key`` is the caller's canonical cert identity; without one, the
        whole verify statement is the key."""
        sig_buf = bytes(sig_buf)
        if key is None:
            mk = (
                bytes(msgs)
                if isinstance(msgs, (bytes, bytearray, memoryview))
                else tuple(bytes(m) for m in msgs)
            )
            key = (mk, tuple(bytes(p) for p in pubs), sig_buf, stride)
        req = _Request((), (), ())
        req.cert = (msgs, pubs, sig_buf, stride, key)
        self._submit(req)

    def _submit(self, req: _Request) -> None:
        with self._cv:
            self._pending.append(req)
            # is_alive, not None: a forked child inherits the thread object
            # but not the running thread.
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._flusher_loop, daemon=True, name="superbatch"
                )
                self._thread.start()
            self._cv.notify()
        req.done.wait()
        if req.error is not None:
            raise req.error

    def _flusher_loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending:
                    self._cv.wait()
                batch = self._pending
                self._pending = []
            try:
                self._flush(batch)
            except BaseException:  # noqa: BLE001
                # _flush's finally released every waiter (error set, never
                # accepted); the flusher must survive or later requests
                # would wait forever.
                pass

    def _flush(self, batch: list[_Request]) -> None:
        certs = [r for r in batch if r.cert is not None]
        triples = [r for r in batch if r.cert is None]
        self.fused_requests += len(batch)
        self.cert_requests += len(certs)
        fused_ok = False
        try:
            if certs:
                self._flush_certs(certs)
            if not triples:
                return
            # Verifying the DISTINCT triples decides the multiset: every
            # duplicate is the same statement, and the RLC gives each
            # distinct triple its own coefficient. A rebroadcast QC's N
            # copies in one window cost one.
            seen = set()
            msgs, pubs, sigs = [], [], []
            for r in triples:
                for m, p, s in zip(r.msgs, r.pubs, r.sigs):
                    key = (m, p, s)
                    if key in seen:
                        continue
                    seen.add(key)
                    msgs.append(m)
                    pubs.append(p)
                    sigs.append(s)
            self.deduped_sigs += sum(len(r.msgs) for r in triples) - len(msgs)
            try:
                self.inner_calls += 1
                if len(msgs) > self.max_sigs:
                    # Oversized fusion: verify per request (one call a QC,
                    # the unfused baseline).
                    raise CryptoError("fused batch too large")
                self.inner.verify_batch(msgs, pubs, sigs)
                fused_ok = True
            except Exception:
                # Isolate: one bad request must not fail its neighbours, and
                # a failure that is not a verdict must fail loudly, not
                # wedge every waiter.
                for r in triples:
                    try:
                        self.inner_calls += 1
                        self.inner.verify_batch(r.msgs, r.pubs, r.sigs)
                    except CryptoError as e:
                        r.error = e
                    except Exception as e:
                        # Not judged: a transient infrastructure failure.
                        r.error = BackendUnavailable(f"verification backend failure: {e!r}")
                    finally:
                        r.done.set()
        finally:
            # Nobody may be left waiting. A request released without having
            # been verified is REJECTED (error set), never accepted.
            for r in batch:
                if not r.done.is_set():
                    if not fused_ok and r.error is None:
                        r.error = BackendUnavailable("verification flush aborted")
                    r.done.set()

    def _flush_certs(self, certs: list[_Request]) -> None:
        """Verify the DISTINCT certs of a fused window, one inner call each.

        Certs dedup by identity: concurrent requests for one cert are one
        statement, priced at one. Each request gets its own verdict object;
        a bad cert fails only its own waiters.
        """
        groups: dict = {}
        for r in certs:
            groups.setdefault(r.cert[4], []).append(r)
        self.cert_deduped_sigs += sum(len(rs[0].cert[1]) * (len(rs) - 1) for rs in groups.values())
        fused = getattr(self.inner, "verify_cert", None)
        for rs in groups.values():
            msgs, pubs, sig_buf, stride, _key = rs[0].cert
            err_text = None
            unavailable = None
            try:
                self.inner_calls += 1
                if fused is not None:
                    fused(msgs, pubs, sig_buf, stride)
                else:
                    self.inner.verify_batch(*_explode_cert(msgs, pubs, sig_buf, stride, len(pubs)))
            except BackendUnavailable as e:
                # The inner backend's own "not judged" (CudaBackend's device
                # failure) stays one; the reference turns it into a verdict.
                unavailable = str(e)
            except CryptoError as e:
                err_text = str(e)
            except Exception as e:
                unavailable = f"verification backend failure: {e!r}"
            for r in rs:
                # A fresh exception per waiter: one instance raised from
                # several threads would race on __traceback__.
                if err_text is not None:
                    r.error = CryptoError(err_text)
                elif unavailable is not None:
                    r.error = BackendUnavailable(unavailable)
                r.done.set()


def enable_superbatching(max_sigs: int = 8192) -> BatchingBackend:
    """Wrap the currently selected backend (idempotent)."""
    current = get_backend()
    if isinstance(current, BatchingBackend):
        return current
    wrapped = BatchingBackend(current, max_sigs=max_sigs)
    set_backend(wrapped)
    return wrapped
