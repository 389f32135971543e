"""Sharded batch verification over a mesh of cards.

Port of ``hotstuff_tpu/parallel/mesh.py``. The MSM lanes are the parallel
axis: each shard decompresses its contiguous block of lanes and runs its
partial MSM on its own card, and the shards' [4, 20] results are combined
by a halving tree of point additions (point addition is the group law, not
a ring sum), then checked as the unsharded verdict checks one point.

The reference runs one program over its mesh (``shard_map``): one process
drives every device it sees, ``all_gather``s the partial points and
``psum``s the ok flags. The port is single-controller too. A ``Mesh`` is a
tuple of ``torch.device``s, and the calling thread launches each shard's
kernels on its own card (distinct cards run them at once), copies each
shard's result point (320 B) and ok flags to the lead card
(``devices[0]``), and launches one ``verdict_tree`` there: the gather's
tree, the ok flags' reduction and the cofactor check in one kernel. The
verdict's bool is the call's one host sync. A process group
(``torch.distributed``) does not fit this call: one engine verifies one
batch in one process, and no other rank would enter the call.

A mesh may name a card more than once: ``cuda:0`` repeated D times runs
the same split, kernels and combine on a one-card host, the shards one
after another.

Departures from the reference:

- the tree carries the last point of an odd-width level into the next
  level; the reference's drops it, so at 3 or 6 devices its verdict
  rejects a valid batch;
- no compile cache: the reference keeps its jitted graphs in
  ``_VERIFIERS`` (``_sharded_cache``, ``_sharded_cached_cache``); the
  port's kernels need none, so ``build_verifier`` and
  ``build_cached_verifier`` build a runner for each call;
- the committee cache stays on the lead card, where each shard's cached
  rows are gathered (``index_select``) and copied to the shard's card. The
  reference replicates ``cache.array`` over the mesh; here no shard can
  read a row that ``DevicePointCache.ensure`` has since written in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from hotstuff_tpu_torch.ops import msm_kernels as mk
from hotstuff_tpu_torch.ops import verify as ov

AXIS = "lanes"


@dataclass(frozen=True)
class Mesh:
    """The cards of a mesh, the lead first; one may appear more than once."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def visible_devices(device_type: str = "cuda") -> list[torch.device]:
    """Every visible card, ``cuda:0`` to ``cuda:n-1``; one entry for another
    device type (``cpu``)."""
    if device_type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh over ``devices`` (default: every visible card), cut to the
    first ``n_devices``."""
    devices = tuple(torch.device(d) for d in (visible_devices() if devices is None else devices))
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise RuntimeError("no CUDA device is available: a mesh needs at least one card")
    if len(devices) > mk.MAX_SHARDS:
        raise ValueError(f"a mesh of {len(devices)} shards (at most {mk.MAX_SHARDS})")
    return Mesh(devices)


def _split(m: int, mesh: Mesh) -> list[slice]:
    """Shard i's rows, ``[i m / D, (i + 1) m / D)``, as ``P(AXIS, None)``."""
    per = m // mesh.size
    return [slice(i * per, (i + 1) * per) for i in range(mesh.size)]


def _combine_partials(mesh: Mesh, accs, oks=None, accs_b=None):
    """Copy the shards' MSM results (and second results, and ok flags) to
    the lead card and combine them there with one ``verdict_tree``:
    (verdict or None, combined point)."""
    lead = mesh.devices[0]
    a = torch.stack([acc.to(lead) for acc in accs])
    b = None if accs_b is None else torch.stack([acc.to(lead) for acc in accs_b])
    ok = None if oks is None else torch.cat([o.to(lead) for o in oks])
    return mk.verdict_tree(ok, a, b)


def msm_sharded(mesh: Mesh, points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Like ``mk.msm`` (unsigned digits) with the lanes sharded over the mesh.

    points: [m, 4, 20], digits: [64, m]; m divisible by the mesh size with
    a power-of-two shard. The combined point, on the lead card.
    """
    m = points.shape[0]
    per = m // mesh.size
    assert m % mesh.size == 0 and per & (per - 1) == 0, "lanes must split into 2^k a device"
    accs = [mk.msm(points[sl].to(dev), digits[:, sl].to(dev))
            for dev, sl in zip(mesh.devices, _split(m, mesh))]
    return _combine_partials(mesh, accs)[1]


def build_verifier(mesh: Mesh, m: int):
    """A sharded verifier for padded lane count ``m``: each shard
    decompresses its lanes (K1) and runs its partial MSM (K4 + K3) on its
    card, then one combine and verdict on the lead. The runner takes the
    packed uint8 [m, 65] batch and returns a 0-dim bool on the lead."""
    n_dev = mesh.size
    assert m % n_dev == 0, "lanes must divide the mesh"
    per_dev = m // n_dev
    assert per_dev & (per_dev - 1) == 0, "per-device lanes must be 2^k"

    def run(packed: torch.Tensor) -> torch.Tensor:
        packed = packed.to(mesh.devices[0])
        oks, accs = [], []
        for dev, sl in zip(mesh.devices, _split(m, mesh)):
            ok, pts, digits = ov.uncached_inputs(packed[sl].to(dev))
            oks.append(ok)
            accs.append(mk.msm(pts, digits))
        return _combine_partials(mesh, accs, oks)[0]

    return run


def build_cached_verifier(mesh: Mesh, mf: int, mc: int):
    """Sharded variant of ``ops.verify.run_cached``: the committee point
    cache on the lead card supplies the A/B points; each shard decompresses
    its fresh R lanes (K1) and runs both signed MSMs (K2 + K3 twice) on its
    card; one combine and verdict on the lead. The runner takes the fresh
    and cached blocks of a split batch (uint8 [mf, 66] and [mc, 66]) and
    the cache's array, and returns a 0-dim bool on the lead."""
    n_dev = mesh.size
    for m, nm in ((mf, "fresh"), (mc, "cached")):
        assert m % n_dev == 0, f"{nm} lanes must divide the mesh"
        per = m // n_dev
        assert per & (per - 1) == 0, f"per-device {nm} lanes must be 2^k"

    def run(fresh: torch.Tensor, cached: torch.Tensor, cache_arr: torch.Tensor) -> torch.Tensor:
        lead = mesh.devices[0]
        fresh = fresh.to(lead).to(torch.int32)
        rows, digits_c = ov.cached_rows(cached.to(lead).to(torch.int32))
        pts_c = cache_arr.index_select(0, rows)  # [mc, 4, 20], gathered on the lead
        oks, accs_f, accs_c = [], [], []
        for dev, sl_f, sl_c in zip(mesh.devices, _split(mf, mesh), _split(mc, mesh)):
            ok_f, pts_f, digits_f = ov.fresh_inputs(fresh[sl_f].to(dev))
            oks.append(ok_f)
            accs_f.append(mk.msm_signed(pts_f, digits_f))
            accs_c.append(mk.msm_signed(pts_c[sl_c].to(dev), digits_c[:, sl_c].to(dev)))
        return _combine_partials(mesh, accs_f, oks, accs_c)[0]

    return run


def _shard_target(m: int, n_dev: int) -> int:
    """Smallest lane count >= m giving each device an equal 2^k shard."""
    per = max(4, -(-m // n_dev))
    while per & (per - 1):
        per += 1
    return per * n_dev


def verify_batch_device_sharded(mesh: Mesh, msgs, pubs, sigs, _rng=None) -> bool:
    """Sharded variant of ``ops.verify.verify_batch_device``: the same host
    prep and padding, byte for byte, then ``build_verifier``'s runner."""
    if len(msgs) == 0:
        return True
    prepared = ov.prepare_batch(msgs, pubs, sigs, _rng=_rng)
    if prepared is None:
        return False
    packed, m = prepared
    # Round lanes up so each device gets an equal power-of-two shard.
    target = _shard_target(m, mesh.size)
    if target > m:
        packed = ov.pad_prepared(packed, target)
    return bool(build_verifier(mesh, target)(torch.from_numpy(packed)))


def verify_batch_device_cached_sharded(mesh: Mesh, msgs, pubs, sigs, cache, _rng=None) -> bool:
    """Sharded variant of ``ops.verify.verify_batch_device_cached``; the
    cache must live on the mesh's lead card."""
    if cache.device != mesh.devices[0]:
        raise ValueError(f"the point cache is on {cache.device}, the mesh's lead is "
                         f"{mesh.devices[0]}")
    if len(msgs) == 0:
        return True
    prepared = ov.prepare_batch_cached(msgs, pubs, sigs, cache, _rng=_rng)
    if prepared is None:
        return False
    packed, mf, mc = prepared
    mf2 = _shard_target(mf, mesh.size)
    mc2 = _shard_target(mc, mesh.size)
    if (mf2, mc2) != (mf, mc):
        packed = ov.pad_prepared_cached(packed, mf, mc, mf2, mc2)
    packed = torch.from_numpy(packed)
    run = build_cached_verifier(mesh, mf2, mc2)
    return bool(run(packed[:mf2], packed[mf2:], cache.array))
