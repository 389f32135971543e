#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``hotstuff_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed 0]

Needs one NVIDIA Hopper card (sm_90a), ``nvcc`` and the repository beside
this file; it exits non-zero without them and prints no result. Phases, each
unguarded (any failure ends the run with a non-zero exit):

1. toolchain: the card's name and power limit, CUDA, nvcc, capability;
2. build: every ``hotstuff_tpu_torch/csrc/*.cu`` with nvcc (timed);
3. the main path: a committee of N = 1000 keys from ``--seed``; in each
   of 3 rounds, 2f+1 signed votes go through ``Aggregator.add_vote`` to a QC
   and ``QC.verify`` runs under ``set_backend(CudaBackend())``. A QC with
   one flipped signature byte must raise ``InvalidSignature``, one QC goes
   through the uncached path. The kernels' launch counts are zeroed just
   before and read just after; each kernel of the path (decompression,
   K2, K3, K4, verdict) must have launched;
4. small-input check: both MSMs against the pure-Python RFC 8032 oracle;
5. kernels against their plain PyTorch versions on the card, on the inputs
   the main path gives them (one QC's batch), limb for limb; the
   decompression with invalid rows (a non-square, x = 0 with sign 1)
   written over padding lanes, the verdict also on a rejected point and on
   an ``ok`` with one False; the root alone (``sqrt_pow``, off the path);
   the full MSMs against the plain ``curve.msm_signed``/``curve.msm`` by
   canonical affine encoding (their additions run in another order; only
   here: every later width holds the kernels limb for limb against their
   plain versions, without the slow plain curve MSM). Each
   kernel is timed at
   each of its main-path shapes by CUDA events and by the profiler's device
   time (``utils/kernel_times.kernel_ms``: the profiler's figure is taken
   where the two differ by more than 10%, and printed as ``nan`` where
   three traces lost the launches), beside its grid, threads per
   CTA, and ptxas' registers and stack bytes;
6. warm per-QC time, split into host prep and the stream span of the copy
   and ``run_cached`` (CUDA events; it includes the gaps where the card
   waits for the host to issue the next op, so it is not device time); a
   warm QC must launch decompression once, K2 and K3 twice, the verdict
   once, and nothing else;
7. a ``torch.profiler`` trace of warm ``QC.verify`` calls: device time
   (the busy time the profiler saw), its share of the wall time, and
   device time and launches by kernel name. A warm QC must stay within
   400 aten ops and 60 device ops (the glue the kernels replaced was
   about 10,700 and 4,150);
8. the node's certificate path under ``set_backend("cuda-batched")``, with
   the process-wide cert arena on (phases 3 to 7 turn it off, so that a
   repeated verify pays what it is counted and timed for). The counts are
   zeroed before and read after; the path's kernels must have launched:
   a. a leader's round-4 ``Block`` carrying the last QC goes out as a v2
      frame (``encode_propose``), is decoded once (``decode_shared``),
      re-encodes byte for byte and verifies with a ``CertificateCache``
      (decompression 1, K2 2, K3 2, verdict 1); an arena hit launches
      nothing;
   b. a view change: 2f+1 ``Timeout``s off the wire, each carrying a v2
      high QC of round 1, 2 or 3, go through ``Aggregator.add_timeout`` to
      a TC; the TC goes out v2 (``encode_tc``) and verifies on the card;
      one flipped signature byte raises ``InvalidSignature``, one vote
      below quorum ``TCRequiresQuorum``; a timeout whose high QC is in the
      node's cache launches nothing;
   c. fusion, made deterministic by a gated ``CudaBackend`` whose first
      call waits until the rest have pooled: the TC, then four
      materialized QCs of pipelined rounds (a leader's own aggregates, or
      v1 frames), must make 2 inner calls, the second of 4 x 2f+1
      signatures; the same four QCs as v2 copies off the wire are cert
      jobs and must make 5 calls of 2f+1 (one per distinct certificate:
      they pool but do not fuse); with one QC tampered, only its waiter
      gets ``InvalidSignature``; eight copies of one QC make one call of
      2f+1 signatures, the rest deduped;
   d. the cached path's kernels against their plain versions at the fused
      flush's width (mf = mc = 4096) and at the widest flush that
      ``max_sigs`` lets through (8192 signatures: mf = 8192, mc = 16384),
      timed as in phase 5; the widest batch must verify;
   e. numbers: a lone QC through ``cuda-batched`` against the direct
      ``CudaBackend``, the fused flush (ms, µs/sig) against its four QCs
      one by one and against the inner calls of the four pooled v2 QCs,
      the widest flush, the TC verify, the v2 decode of the proposal, and
      on one QC on the card's host the serial ``CpuBackend(use_rlc=False)``
      beside the default ``CpuBackend()`` (its native RLC engine, which
      must be built);
9. the consensus engine on the card: an in-process committee of N = 100
   port engines (``Consensus.spawn``) on 127.0.0.1, keys from ``--seed``,
   stake 1 each (quorum 67), ``timeout_delay`` 30 s, batched vote
   verification, wire v2, an in-memory store each, mempool channels sunk,
   under ``set_backend("cuda-batched")`` with the cert arena on. After the
   first commit on every engine, 10 rounds are timed: every engine must
   commit the same digest each round, no timeout may fire and no
   verification may meet ``BackendUnavailable``; the launch counts are
   zeroed before and read after (decompression, K2, K3 and the verdict
   must launch, K4 must not), with ``BatchingBackend``'s inner calls,
   requests and signatures per round. Then 3 rounds under
   ``torch.profiler`` for the card's busy share; then the same committee
   (keys from ``--seed`` + 1) under the serial ``CpuBackend(use_rlc=False)``
   as the yardstick, and under the default ``CpuBackend()`` (the native RLC
   engine, the reference's default) beside it; then the card committee of
   the first run again (ports from 10800) with telemetry on, the engines'
   per-stage counters (``Consensus.spawn(profile=True)``:
   ``consensus.stage.<kind>.{ns,calls}``) and a sampling profiler with stage
   tags at its default 2 ms over the timed rounds, read as the reference's
   ``benchmark/committee_scale.py`` reads its ``--profile`` run (counter
   deltas around the rounds). It prints ms per round beside the unprofiled
   run, each stage's ms and calls a round, their sum as a share of the
   round's wall time, each stage tag's share of the samples, and the
   superbatcher's ``flush_ms`` and ``per_sig_ms`` means; it fails unless
   every stage seen made calls, ``consensus.rounds_advanced`` moved by at
   least the rounds, ``crypto.dispatch.cuda`` by the verdict's launches (=
   the superbatcher's inner calls = ``CudaBackend``'s calls),
   ``crypto.dispatch.cuda_sigs`` by the signatures dispatched, and the
   profiler's ``hotstuff-profile-v1`` record validates. Telemetry is off in
   the other runs and is turned off and cleared after this one. In every
   card run the timed rounds' counts are read between inner calls (a gate
   each inner call holds). Then the cached kernels at the committee's width
   (one N = 100 QC: mf = mc = 128) against their plain versions, limb for
   limb.
   The soft ``RLIMIT_NOFILE`` is raised to the hard one before the port's
   network package is imported (a full mesh of 100 engines needs about
   20,000 descriptors; the connection budget takes 35% of the soft limit);
10. the mempool and the node:
   a. the SHA-512 kernel (``csrc/sha512.cu``) against its plain version on
      the card, byte for byte, and both against ``hashlib``: lengths 0, 1,
      32, 96, 111, 112, 127, 128, 239, 240 and 300 in one drain, 128 lanes
      of 0-1024 B, 1024 lanes of 96 B (the challenge input), 1, 31, 32, 33
      and 129 lanes of 0-1100 B (a CTA holds 32), and a ragged CTA (0 B
      beside 40 kB and short lanes); then against ``hashlib`` alone (the
      plain version walks blocks in Python) on a ragged CTA of 0 B beside
      500 kB, on the reference digest bench's grid, drains of 8, 32 and
      128 messages of 512 B, 15 kB and 500 kB, on 128 mempool batches of
      12-30 transactions of 512 B, and on the node path's shapes: 1024 x
      96 B, 2 and 3 x 15 kB, 18 x 15,485 B;
   b. for each drain of the grid and the node path's shapes: the kernel's
      time (CUDA events and the profiler, as phase 5), the pinned
      host-to-device copy apart, the whole ``sha512_32_batch`` and its
      host parts (pack, H2D, launch and kernel, D2H, split into bytes; host
      clock, synchronized after each, inside the call), ``hashlib`` on the
      card's host, the bound, ptxas' usage and the static SASS instruction
      counts of the kernel, and the modelled chain and issue floors (from
      the constants below, printed as a model and kept out of the JSON
      line);
   c. BASELINE.json config 1, the reference's ``fab local`` setting: four
      port ``Node``s in this process (after a full collection, with every
      object the earlier phases left alive frozen out of the garbage
      collector: a full collection stops the event loop for as long as it
      takes to traverse every tracked object, and over the earlier phases'
      heap that came near the 1 s consensus timer), each on a store in a
      temporary directory (the node's default engine, ``NativeEngine``), keys from ``--seed``, timeout 1 s, 15 kB
      batches sealed at 10 ms at the latest, device digests on, the
      backend chosen by ``HOTSTUFF_CRYPTO_BACKEND=cuda-batched`` at the
      first ``get_backend()``; four port clients (``node.client``) at 250
      tx/s of 512 B each. After the first payload commit on every node the
      counts are zeroed and 10 s are measured. It fails unless every node
      commits the same sequence of payload blocks, every committed digest
      reads back from all four stores and is the SHA-512/32 of the stored
      bytes, every sample transaction sent up to 1 s before the window's
      end is in a committed batch of the node it was sent to, no timeout
      fires in the window, ``sha512`` launches (a drain of more than one
      batch) and so do the QC kernels (decompression, K2, K3, verdict),
      and K4 does not. It prints committed tx/s, rounds/s, p50 and p95
      send-to-commit latency of the sample transactions, the drain sizes,
      the batches hashed on the card and on the host, the card's
      verifications by signature count and each kernel's launches; then
      holds the cached path's kernels (decompression, K2, K3, verdict)
      against their plain versions, limb for limb and timed as in phase 5,
      at every (mf, mc) the window ran them at, each on a batch the path
      verified at that width (a QC of 3 signatures: mf = mc = 4), and the
      digest kernel against its plain version at the widest drain the node
      path gave it, timed there. Each node streams its telemetry
      (``HOTSTUFF_TELEMETRY_DIR``, a directory of the run's temporary tree):
      it fails unless every node's stream passes the port's validator line
      by line and its final snapshot shows ``consensus.qcs_formed``,
      ``mempool.batches_sealed`` and ``net.frames_in`` above 0, and prints
      the committed tx/s the final snapshots give (the harness reader's
      formula) beside the logs';
11. the mempool's data plane (Conveyor): the README's configuration at the
   reference sweep's defaults (``README.md:107``,
   ``benchmark/dataplane_sweep.py:150-160``), four port ``Node``s with two
   workers each in this process (after the same collection and freeze as
   10c), stores on disk (``NativeEngine``), keys from ``--seed``, timeout 2 s, 512 B
   transactions, 250,000 B batches sealed at 50 ms at the latest,
   ``HOTSTUFF_CRYPTO_BACKEND=cuda-batched``; four sharded port clients
   (``node.client.run_sharded_client``) at 5,000 tx/s each, 20,000 offered,
   each to its node's two worker ingress ports in ``benchmark/local.py``'s
   port layout from 10400. Every ack and availability certificate is checked
   on the host with the strict single ``Signature.verify``, as in the
   reference; the card verifies consensus's QCs. After the first payload
   commit on every node, 10 s are measured (launch counts zeroed just
   before, read just after). It fails unless every node commits the same
   sequence of payload blocks, every committed batch reads back from all
   four stores, parses as a worker batch and hashes to its digest, a
   certificate of it is in at least three stores and decodes with the seat
   table and verifies, every sample transaction sent up to 1 s before the
   window's end is committed, no timeout fires, and the decompression, K2,
   K3 and the verdict launch while K4 does not. It prints committed and
   consensus tx/s, p50 and p95 end-to-end and consensus latency, rounds/s,
   the bundles shed and the clients' rate misses, batches sealed,
   certificates formed, acks invalid, batches the resolvers fetched, each
   kernel's launches, ``CudaBackend`` calls by width and the collector's
   pauses; then holds the cached path's kernels against their plain
   versions at every (mf, mc) the window ran them at, as 10c does;
12. replica rejoin (state sync and log compaction):
   a. the reference's real-plane rejoin scenario (``benchmark/scenarios/
      rejoin.json``; ``hotstuff_tpu/faultline/harness.py:70-81``'s
      defaults): four port engines (``Consensus.spawn``, mempool channels
      sunk) on ``LogEngine`` stores, keys from ``--seed``, timeout 1 s,
      batched vote verification, wire v2, ``retention_rounds`` 16,
      ``HOTSTUFF_CRYPTO_BACKEND=cuda-batched``, ports from 10500. Engine 1
      crashes uncleanly 2 s after the first commit everywhere; at 8 s every
      survivor must have written a snapshot record and compacted (its
      rewrite drained, no block it committed below its floor reads back);
      then the cert arena and the launch counts are reset and engine 1
      restarts on a new, empty store. It fails unless the joiner installs a
      verified snapshot whose frontier lies above what it had committed
      (each install it makes does: a survivors' floor that passes it while
      it catches up is installed again, as in the reference), commits 3
      blocks within 30 s of the restart, every round committed on several
      engines has one digest, each engine's commits of one life form a
      chain above its floor, no verification met ``BackendUnavailable``,
      and the snapshot's two QCs went to the card between the restart and
      the end of the first install: every card call whose messages hold
      the vote digest of either QC launched exactly a warm QC's kernels
      (decompress 1, K2 2, K3 2, verdict 1, no K4), and each digest is in
      one. The survivors verified those QCs rounds before the restart, so
      these calls are the joiner's: in ``verify_snapshot``, or earlier in
      its chain walk through the helpers' replies, which carry the same
      QCs (``verify_snapshot`` then meets them in the core's certificate
      cache). It prints the time to recover (restart to the joiner's first
      and third commits), each install's frontier beside the survivors'
      heads, each survivor's compactions, bytes freed, keys dropped and
      ``store.log`` peak and final sizes, the probes sent, the snapshot's
      calls, and the card's calls by width;
   b. a warm restart at config 1 (phase 10c's configuration at
      ``retention_rounds`` 16, ports from 10510): after the first payload
      commit on every node, node 2 ``crash()``es and ``restart()``s 3 s
      later on its own store; 8 s on, the clients stop. It fails unless
      node 2 restores the floor of its own snapshot record when it has one,
      commits a payload block again, one digest a round on every node, the
      running nodes' payload sequences agree and node 2's is theirs in
      their order, and every sample transaction sent to nodes 0, 1 and 3
      up to 1 s before the end is committed, or its batch was proposed only
      in a block that no node committed (a block proposed just before a
      round whose leader is down gets no QC, and every proposer drops its
      payload on processing it, as in the reference; such samples are
      counted apart). It prints the time to recover and the rounds lost;
   c. the snapshot check at phase 3's N = 1000: a record ``(F, c1, cert)``
      of signed blocks whose QCs are 667-vote QCs of consecutive rounds,
      decoded with ``decode_snapshot`` and verified with ``verify_snapshot``
      (cert arena reset before each): 2 inner calls, launching decompress 2,
      K2 4, K3 4, verdict 2 and nothing else; a flipped vote byte raises
      ``InvalidSignature``; a cert of another block raises ``SnapshotError``
      with no launch. It prints ms per snapshot verify beside two lone
      ``QC.verify``s (CUDA events, in turns, median of 10 each); then the
      cached kernels against their plain versions at every (mf, mc) that
      parts a-c ran them at;
13. the sharded verifier (``hotstuff_tpu_torch/parallel/mesh.py``):
   a. the tree-combine verdict (``verdict_tree``) against its plain version
      on the card, limb for limb and the same bool, at 1, 2, 3, 4, 6 and 8
      shards, with and without the second MSM's results, over phase 3's
      1024 fresh-lane ok flags (points from the seed whose sum is the
      identity; an ok with one False rejected; the point alone the same),
      timed as in phase 5;
   b. phase 3's first QC through ``verify_batch_device_cached_sharded`` and
      ``verify_batch_device_sharded`` on meshes of ``cuda:0`` repeated 1, 2,
      3, 4 and 8 times (the counts zeroed before and read after). On each,
      the QC is accepted on both paths; a warm QC launches exactly
      decompress D, K2 2D, K3 2D, ``verdict_tree`` 1 (cached) and decompress
      D, K4 D, K3 D, ``verdict_tree`` 1 (uncached), and nothing else; a
      signature whose R moved to R + B (a valid point) is rejected in each
      shard that holds a signature, on both paths, as the unsharded paths
      reject it. ``msm_sharded`` over 4 shards equals the unsharded MSM by
      canonical affine encoding. It prints ms per QC by D beside the
      unsharded calls, in turns (host clock, median of 5; on one card the
      shards run one after another);
   c. with more than one card visible, 13b over distinct cards;
14. the port's bench (``bench_torch.py``) at its default 1343 signatures
   (``make_batch``'s seed): the serial ``CpuBackend(use_rlc=False)`` and the
   native RLC engine (``CpuBackend().engine`` must be ``native-rlc``), then
   its cached and uncached device paths on the card, the counts zeroed
   before each and read after. Each path verifies 1 + 4 + 3 x 8 batches
   (its warm verify, one a pool thread, 3 rounds of 8), every one accepted;
   the cached path must launch exactly decompress 30 (one more for the
   committee keys entering its cache), K2 58, K3 58, verdict 29 and nothing
   else, the uncached exactly decompress 29, K4 29, K3 29, verdict 29. It
   prints the bench's JSON line (not as the last line), stamped with the
   card, which must be the one of phase 1, each path's host prep alone
   (``prepare_batch_cached`` and ``prepare_batch`` on one thread, host
   clock, median of 5), then the kernels against their
   plain versions at the bench's widths, limb for limb and timed as in
   phase 5: K1 over the fresh R lanes (mf = 2048) and over every uncached
   lane (m = 4096), K2 + K3 at [2048] x 33 and x 64, K4 + K3 at [4096] x
   64, the verdict and the root alone;
15. faultline on the card (``hotstuff_tpu_torch/faultline``), with telemetry
   on and ``set_backend("cuda-batched")`` made after it, the cert arena
   on, the port's ``run_scenario`` at a 1 s timeout and each scenario read
   from ``benchmark/scenarios/`` by path. Around each run the counts are
   zeroed and ``crypto.dispatch.cuda`` read, under a lock that every card
   call holds. Each run must be safe and recovered, its trace the compiled
   schedule's, every transition applied, its faults fired (dropped frames
   where links are cut, crashes and restarts counted, proposals
   suppressed under a silent leader, an actor spawned for
   ``stale_vote_flood``), decompress, K2 signed, K3 and the verdict
   launched, K4 and the root alone not, and the counter moved by exactly
   the verdict's launches:
   a. ``rejoin.json`` at N = 4 and retention 16 with the frontier
      availability audit, its trace and snapshot records streamed to a
      file (phase 19d runs the classes of ``crash.json``,
      ``partition.json`` and ``delay-reorder.json``, a crash, a partition
      and delayed, duplicated and reordered links, at N = 20 on both
      planes, and 16d runs ``partition.json`` itself natively);
   b. ``storm-n20.json`` at N = 20 (a crash, a partition, lossy links, a
      silent leader and a stale-vote flooder);
   c. an 8 s scenario with no events at N = 4, its stream fed to the port's
      ``Watchtower`` one line at a time: no alert may be raised, and some
      round must be scored; then b's storm, whose alerts are printed;
   d. phase 11's data plane (ports 11100-11135) with
      ``HOTSTUFF_FAULTLINE`` naming a scenario in which node 2 runs
      ``batch_withhold`` from 2 s to 8 s of 10 s. The four nodes run in
      this one process, each booted in a task of its own so that each
      keeps its own identity, under the one plane the first armed (the
      reference arms one plane per process, one node each). Every sample
      must commit, ``faultline.injected.acks_withheld`` must rise, and the
      cached path's kernels launch (K4 never);
16. the native plane (``network/native/``, the C++ epoll transport with its
   vote pre-stage, and ``store/native/``), in a child process that this one
   starts with ``HOTSTUFF_NET=native`` and ``HOTSTUFF_CRYPTO_WORKERS=32`` (both
   read at import) and the cert arena on; it prints its lines, and this
   process fails unless it exits 0 within 480 s having printed every part's
   line and its result line (each part's launches). Nothing falls back to
   asyncio: the child fails unless the network package's three classes are
   the native ones.
   a. phase 9's committee (N = 100, quorum 67, ``cuda-batched``, 10 timed
      rounds, ports 11200-11299) with telemetry on: ms per committed round
      beside phase 9's asyncio figure of this call, the C++ pre-stage's
      ``votes_batched``, ``votes_dropped`` and ``votes_dropped_dup`` over the
      timed rounds, ``crypto.dispatch.cuda`` (it must equal the verdict's
      launches), and the launches a round; every inner call decompress 1
      (more: keys entering the card's cache), K2 2, K3 2, verdict 1, K4 never;
   b. BASELINE config 4 in protocol mode, as the reference's
      ``HOTSTUFF_NET=native committee_scale.py --mode protocol --nodes 1000``:
      N = 1000 engines (f = 333, quorum 667, keys from ``--seed``) on ports
      12000-12999, ``cuda-batched``, cert and decode arenas on, wire v2,
      batched vote verification, timeout 30 s. After the first commit on
      every engine, 5 timed rounds (the reference's default is 20; the one
      cut, to keep the whole run under 15 minutes): every engine commits the same
      digest each round and no timeout fires; each inner call launches as in
      a. It prints ms per committed round, the open fds at the window's end,
      and per round the inner verify calls, signatures and launches;
   c. phase 10c's config 1 (four nodes, 1000 tx/s of 512 B, 10 s) on ports
      11300-11399, each node's store on disk: committed tx/s, e2e p50 and
      p95, and each store's engine, which must be ``NativeEngine``;
   d. ``benchmark/scenarios/partition.json`` at N = 4 as phase 15a runs it,
      on ports 11400-11499, consensus receivers and vote broadcasts on the
      C++ engine: safe, recovered, its trace the compiled schedule's; its
      injection counts and recovery seconds after the heal.
17. engine groups and the sim plane, run right after phase 2 (each group is
   a spawned interpreter, started without this script as its main module);
   this process launches no kernel in 17a-b (its counts are read before and
   after, and must be unchanged), 17c's children run beside phases 3-5 and
   are waited for before phase 6, and after phase 16 it prints 17a's and
   17b's ms per round beside phase 9's and 16a-b's:
   a. ``EngineGroupRuntime`` (``parallel/engine_groups.py``): BASELINE config
      2's shape, N = 100 (quorum 67, timeout 30 s) in 4 worker processes
      started by spawn, each with phase 16's environment and
      ``HOTSTUFF_CRYPTO_BACKEND=cuda-batched`` (so each group verifies its
      QCs on the card with its own backend, transport and arenas), ports
      13000-13099. After the first commit on every node, 10 rounds are
      timed. It fails unless every node commits every timed round, no
      timer can have fired in them (no node went the 30 s timeout without a
      commit reaching into them: every commit record's arrival is timed),
      every group's ``crypto.dispatch.cuda`` moved, each group launched a
      verdict and no more verdicts than it made card calls (a call still
      in flight at its count may not have launched), and decompress, K2,
      K3 and verdict each
      launched in the groups (each group counts its own launches from 0
      after it makes its backend, and ``stop`` sums them). It prints ms per
      committed round, the timeouts and TCs of the whole run (a boot's: a
      round whose leader's engine was not listening yet loses its votes and
      waits out its timeout) with the timed-out rounds from the groups'
      standard error (kept in a file), each group's ready time,
      ``crypto.dispatch.cuda``, ``_sigs`` and launches, the merged
      ``parallel.ring.*``, and the host's load, memory and CPU affinity as
      the groups see them;
   b. the same for BASELINE config 4 in protocol mode, as the reference's
      ``committee_scale.py --mode protocol --nodes 1000 --groups 8`` runs it:
      N = 1000 (quorum 667) in 8 groups, ports 13100-14099, 5 timed rounds
      (its default is 20; the one cut, as 16b's), with the seconds to the
      first commit and the open descriptors summed over the groups at the
      window's end;
   c. the sim plane (``hotstuff_tpu_torch/sim``) through the port's scripts,
      each from its command line as phase 18 runs them, the two started
      together after 17b and waited for after phase 5 (each sets the
      ``cpu`` backend for its own process: the sim verifies inline, and
      under a backend named ``cuda`` it cannot run): ``sim_sweep --seeds
      0:300 --twins 24 --inject-wedge --gate --artifacts <tmp> --out <tmp>``,
      chaos seeds 0-299 and 24 enumerated twins scenarios at N = 4, each
      safe and recovered under the checker, and the injected wedge (two
      permanent crashes at N = 4) shrunk to a reproducer of its two crashes
      that replays in this process to the liveness violation; then
      ``detector_sweep --seeds 0:60 --labeled-seeds 10 --controls 10
      --config preset:tuned-n4 --gate --out <tmp>``, the watchtower's tuned
      preset scored on labelled sim runs rendered as telemetry streams:
      recall 1.0 on the pinned incidents, no alert on a fault-free control,
      and the preset's fingerprint. It prints seeds a minute from the
      summary.
18. the measurement harness: the port's copies of the reference's benchmark
   scripts (``hotstuff_tpu_torch/benchmark/``), each child started as
   ``python -m hotstuff_tpu_torch.benchmark.<name>`` in a session of its own
   (killed with everything it started after it ends, or after 300 s), its
   output printed, with no ``HOTSTUFF_*`` switch but those named here:
   a. ``committee_scale --mode crypto --rounds 20 --output <tmp>`` under
      ``HOTSTUFF_CRYPTO_BACKEND=cuda`` with ``HOTSTUFF_CERT_ARENA=0`` (so
      every round pays its verifies) at ``--nodes 400`` (BASELINE config
      3), ``--nodes 1000`` (config 4) and ``--nodes 1000 --tc-heavy`` (its
      view-change regime): each printed line must parse, say what was asked
      for, ``backend=cuda`` and ``transport=asyncio``, and be what its
      result file holds. Then ``run_crypto_rounds`` of each in this process
      under ``cuda`` with the counts zeroed before and read after: each
      verify (the warm-up and 20 rounds, a QC and with ``--tc-heavy`` a TC)
      launches K2 2, K3 2, verdict 1, decompress at least 1 (keys entering
      the card's cache), K4 never. The cached kernels are held against
      their plain versions at each width (mf, mc) it ran that no earlier
      phase held;
   b. ``committee_scale --mode protocol --nodes 100 --rounds 10 --profile
      --telemetry <tmp> --base-port 14100`` under ``cuda-batched`` and
      ``HOTSTUFF_NET=native``: its line must say ``transport=native``, its
      stage table must have rows, its result file must hold both, and its
      stream's ``crypto.dispatch.cuda`` must move between the first and the
      last snapshot;
   c. ``digest_bench`` on its default grid (8/32/128 drains of 512 B,
      15 kB and 500 kB) in this process, with the counts zeroed before and
      read after: ``sha512`` launches 7 times a drain (the script's own
      check against ``hashlib``, its warm-up and 5 timed calls) and no
      other kernel; then from its command line for the ``RECOMMEND`` line;
   d. ``superbatch_bench`` with its defaults (24 QCs of 67 signatures,
      8 threads) under ``cuda`` in this process, the counts zeroed before
      and read after: 79 requests, and K2 2, K3 2, verdict 1 for each
      ``CudaBackend`` call (31 lone and 48 contended on the plain backend,
      and the wrapper's inner calls), decompress at least as many, K4
      never; the kernels held at the widths no earlier phase held;
   e. ``run_local --nodes 4 --rate 1000 --duration 5 --telemetry
      --base-port 14300 --crypto-backend cuda`` (BASELINE config 1, four
      node and four client processes; 5 s of the script's default 20, a
      cut: 10c and 16c run config 1 as well): exit 0 (``LogParser`` rejects
      a panic), the SUMMARY's TPS and latencies parse, consensus TPS above
      0, and each node's stream's ``crypto.dispatch.cuda`` above 0. Its
      committed tx/s is printed beside 10c's.
19. the data-plane and robustness harness: the port's copies of the
   reference's ``dataplane_sweep``, ``fleet_bench``, ``soak`` and
   ``fault_matrix``, each from its command line as phase 18 runs them, under
   the card's default backend unless the line names one; a, b and c run
   alone, d's command line (one N = 20 committee at a time) beside d's run
   in this process:
   a. ``dataplane_sweep --nodes 4 --workers 2 --rates 20000 --duration 6
      --dtrace --base-port 14400`` (phase 11's Conveyor setting as eight
      node and four client processes; 6 s, a cut: the script's default is
      20 s): its point has no ``error``, e2e TPS
      above 0 and a shed count; its lifeline report has no ``error`` and
      every batch closes the seven edges or names its open edge; both
      artifacts carry the reference's names; every node stream's
      ``crypto.dispatch.cuda`` is above 0;
   b. ``fleet_bench --nodes 4 --workers 2 --rate 20000 --fleet 256
      --bundle-txs 8 --duration 6 --base-port 14800`` (the script
      docstring's first example at 6 s of its 30, a cut): the artifact holds
      e2e TPS, p99 and p99.9, sheds, churns and the ingress watermark; every
      node stream's ``crypto.dispatch.cuda`` is above 0;
   c. ``soak --nodes 4 --rate 500 --duration 30 --chaos-seed 7
      --watch-config preset:tuned-n4 --base-port 15200``, alone: the
      checker finds the run safe and the log parse no panic; the checker's
      liveness verdict (with the post-heal commits) and the SLO engine's
      (with every breached SLO) are printed and not required: after this
      schedule's last heal both packages' committees sometimes stall for
      good, on any host (ROADMAP §3 F11), and chaos seed 7's degraded share
      of windows sits at the engine's 0.34 allowance. The script's verdict
      line and exit code (0 PASS, 1 FAIL) must be the conjunction of the
      three judges; every live alert carries the tuned preset's
      fingerprint, and the node streams' ``crypto.dispatch.cuda`` moved.
      19d's fault matrix is where recovery is required;
   d. ``HOTSTUFF_CRYPTO_BACKEND=cuda-batched fault_matrix --nodes 20
      --duration 8 --base-port 15400`` (the committee of the reference's
      ``results/fault-matrix-n20.json``; 8 s of its 12, a cut): crash-f6, a
      minority partition and delay+dup+reorder on both transport planes,
      each plane a child in a session of its own, every verdict safe and
      recovered. Beside it ``run_plane`` of the same in this process on its
      (asyncio) plane from port 15500 with 4 s scenarios, every verdict
      safe and recovered, the counts zeroed before and read
      after under a lock each ``CudaBackend`` call holds: K2 and K3 twice a
      call, the verdict once, the decompression once a call plus once a key
      cache insert, K4, the root alone, ``verdict_tree`` and SHA-512 never.
      The cached kernels are held against their plain versions at each
      width it ran that no earlier phase held, once the command line's
      child has ended.
20. the measurement tools: the port's copies of the reference's
   ``regress``, smoke gates and profilers, each from its command line as
   phase 18 runs them (but c):
   a. ``regress --nodes 40 --rounds 12 --repeats 2 --skip-crypto
      --base-port 15600`` under ``cuda-batched``, alone, then ``regress
      --skip-protocol``: each report parses, its check says ``compared``
      against the baseline committed from the card's host
      (``results/committee-protocol-cuda-batched-40.txt``,
      ``results/bench-torch-1343-h100.json``), and its verdict line and exit
      code say its report's GREEN or RED, which is printed with the ratio and
      not required (hosts of one card differ by more than the gate's 1.5x);
   b. ``telemetry_smoke``, ``profile_smoke`` and ``watchtower_smoke`` at
      ``--nodes 10 --repeats 2`` under ``cuda-batched`` (ports 14200, 14828,
      14928), started together, with a's crypto check and d beside them:
      each exits 0, or 2 over its overhead budget (which stays 1%) with the
      overhead printed; no schema, record, ingest or alert problem; every
      telemetry stream it wrote shows ``crypto.dispatch.cuda`` moving;
   c. ``profile_device 1343`` in this process, alone, the counts zeroed
      before and read after: every stage of the reference printed, each
      stage's 50 calls (2 warm-ups, 3 rounds of 16) launching exactly the
      kernels it names (the pipeline K1, K4, K3 and the verdict; the root
      alone ``sqrt_pow``; ...) and no other; then the root alone against its
      plain version at the profile's 4096 lanes (phase 14 held K4 and K3
      there);
   d. ``sample_profile --nodes 40 --rounds 10 --by-stage``, ``diag_protocol
      --nodes 40 --seconds 10`` and ``profile_protocol --seconds 5`` under
      ``cuda-batched`` (ports 15028, 15068, 15760; each a cut from the
      reference's 15 rounds, 60 s and 20 s): each exits 0 and prints its
      table; the diagnostic's commits are printed, not required (a
      committee's round 1 can wait out its 30 s timeout at boot);
   e. ``dtrace_smoke --repeats 2`` (ports 14428-14791) and ``netplane_frames
      --sizes 1024,65536,396288 --frames 200`` (14321-14326), which make no
      card call, started beside phases 3-5 with 17c's children: the lifeline
      smoke exits 0 or 2 with no problem; every frame of every row acked, the
      native rows with the engine's counter deltas.
21. the README's crash-fault quick start through the port's CLI, ``fabfile
   local --nodes 4 --faults 1 --rate 600 --duration 5 --save`` (5 s of the
   README's 20, a cut), from its command line as phase 18 runs its scripts
   but in a temporary working directory (its ``.bench``, ``results/`` and
   ``plots/``), with ``HOTSTUFF_CRYPTO_BACKEND=cuda`` and the node streams'
   ``HOTSTUFF_TELEMETRY_DIR`` passed to it (``LocalBench``'s ports
   9000-9011): the SUMMARY says 4 nodes with 1 faulty and consensus TPS
   above 0; exactly three node streams, each with ``crypto.dispatch.cuda``
   above 0 (the faulty fourth node is never booted); the result file
   ``results/bench-1-4-600-512.txt`` holds the printed SUMMARY. Then on the
   host ``fabfile logs --dir .bench/logs --faults 1`` prints the same
   SUMMARY from the same logs, and ``fabfile aggregate`` writes the series
   ``plots/agg-l-1-4-x-512.txt`` with the run's one rate. ``plot`` is not
   run here (the host may lack matplotlib); it, ``remote``, ``instance`` and
   ``netns`` reach no card and are held on the CPU only.

The last two lines are a JSON object per kernel (``{"kernels": [...]}``;
``launches`` from phase 3 (``sha512``'s too, counted there like the
others'); ``launches_node_path`` from phase 8, the ``fused_*`` and ``widest_*``
keys from 8d, ``launches_committee`` and the ``committee_*`` keys from
phase 9, ``launches_committee_profiled`` from its profiled run,
``launches_config1`` and the ``config1_*`` keys from phase 10c:
the QC kernels' at its widest width, ``sha512``'s at its widest drain;
``launches_conveyor`` and the ``conveyor_*`` keys from phase 11,
``launches_rejoin`` from phase 12a's restart to the end of its first install
(every engine's), ``launches_rejoin_snapshot`` from the card calls that
verified the snapshot's two QCs in that window, and the ``rejoin_*`` keys at
phase 12's widest width; ``launches_sharded`` from phase 13b, which is also
``verdict_tree``'s ``launches``, since only the sharded path reaches it; its
row's times at 8 shards with both MSMs' results, and its
``sharded_ms_per_qc`` by D (cached, uncached) beside ``unsharded_ms_per_qc``;
``launches_bench_cached`` and ``launches_bench_uncached`` from phase 14's two
runs, and its ``bench_*`` keys at the bench's widths, the decompression's
``bench_uncached_*`` at every uncached lane; ``launches_faultline`` from all
of phase 15's runs together; ``launches_native_n100``, ``_n1000``, ``_config1``
and ``_faultline`` from phase 16's parts a-d; ``launches_groups_n100`` and
``_n1000`` from phase 17a-b, counted in the groups and summed over them;
``launches_harness_crypto``, ``_digest`` and ``_superbatch`` from phase
18a, c and d in this process, the ``harness_crypto_*`` and
``harness_superbatch_*`` keys at the widest width that 18a and 18d held
first; ``launches_harness_fault_matrix`` from 19d's ``run_plane`` in this
process and the ``harness_fault_matrix_*`` keys at the widest width it held
first; and on the verdict's row ``harness_dispatch_cuda``, the
``crypto.dispatch.cuda`` that 18b's, 18e's, 19a's, 19b's, 19c's and 21's
node processes streamed (21's under ``fabfile_local``);
``launches_profile_device`` from phase 20c in this process, which is also
``sqrt_pow``'s ``launches``, since its root-alone stage is the only path that
reaches it, and the ``profile_device_*`` keys at the widths 20c held first)
and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import asyncio
import atexit
import contextlib
import contextvars
import functools
import gc
import glob
import hashlib
import io
import json
import logging
import os
import random
import re
import resource
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch


def raise_fd_limit() -> tuple[int, int, int]:
    """Raise the soft ``RLIMIT_NOFILE`` to the hard one (capped at Linux's
    default ``nr_open``). Returns (soft before, soft after, hard)."""
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    target = hard if hard != resource.RLIM_INFINITY else 1 << 20
    try:
        resource.setrlimit(resource.RLIMIT_NOFILE, (max(soft, target), hard))
    except (ValueError, OSError):
        pass
    return soft, resource.getrlimit(resource.RLIMIT_NOFILE)[0], hard


# Before the port's network package is imported: its connection budget is
# computed from the soft limit once, at import.
FD_LIMITS = raise_fd_limit()

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import bench_torch  # noqa: E402
from hotstuff_tpu_torch import crypto, faultline, network, telemetry  # noqa: E402
from hotstuff_tpu_torch.benchmark import committee_scale, digest_bench, logs  # noqa: E402
from hotstuff_tpu_torch.benchmark import fault_matrix, profile_device, superbatch_bench  # noqa: E402
from hotstuff_tpu_torch.consensus import Consensus, Parameters, cert_arena, errors  # noqa: E402
from hotstuff_tpu_torch.consensus.aggregator import Aggregator  # noqa: E402
from hotstuff_tpu_torch.consensus.config import Authority, Committee  # noqa: E402
from hotstuff_tpu_torch.consensus import decode_arena  # noqa: E402
from hotstuff_tpu_torch.consensus.decode_arena import decode_shared  # noqa: E402
from hotstuff_tpu_torch.consensus.statesync import (  # noqa: E402
    SNAPSHOT_KEY,
    SnapshotError,
    decode_snapshot,
    encode_snapshot,
    peek_frontier,
    verify_snapshot,
)
from hotstuff_tpu_torch.consensus.messages import (  # noqa: E402
    QC,
    TAG_PROPOSE,
    TC,
    Block,
    CertificateCache,
    SeatTable,
    Timeout,
    Vote,
    decode_message,
    encode_propose,
    encode_tc,
    encode_timeout,
)
from hotstuff_tpu_torch.crypto import ed25519_ref as ref  # noqa: E402
from hotstuff_tpu_torch.crypto.batching import BatchingBackend  # noqa: E402
from hotstuff_tpu_torch.crypto.cuda_backend import CudaBackend  # noqa: E402
from hotstuff_tpu_torch.mempool import Authority as MempoolAuthority  # noqa: E402
from hotstuff_tpu_torch.mempool import Committee as MempoolCommittee  # noqa: E402
from hotstuff_tpu_torch.mempool import Parameters as MempoolParameters  # noqa: E402
from hotstuff_tpu_torch.mempool import processor  # noqa: E402
from hotstuff_tpu_torch.mempool.messages import decode as decode_batch  # noqa: E402
from hotstuff_tpu_torch.mempool.messages import encode_batch  # noqa: E402
from hotstuff_tpu_torch.network import native as native_net  # noqa: E402
from hotstuff_tpu_torch.network import reliable_sender, simple_sender  # noqa: E402
from hotstuff_tpu_torch.network.budget import BUDGET  # noqa: E402
from hotstuff_tpu_torch.ops import curve as cv  # noqa: E402
from hotstuff_tpu_torch.ops import field as fe  # noqa: E402
from hotstuff_tpu_torch.ops import msm_kernels as mk  # noqa: E402
from hotstuff_tpu_torch.ops import sha512 as sha  # noqa: E402
from hotstuff_tpu_torch.ops import verify as ov  # noqa: E402
from hotstuff_tpu_torch.parallel import mesh as pm  # noqa: E402
from hotstuff_tpu_torch.parallel.engine_groups import EngineGroupRuntime  # noqa: E402
from hotstuff_tpu_torch.sim.shrink import sim_failure_probe  # noqa: E402
from hotstuff_tpu_torch.store import LogEngine, Store  # noqa: E402
from hotstuff_tpu_torch.telemetry import profiler as pyprof  # noqa: E402
from hotstuff_tpu_torch.telemetry.validate import validate_stream  # noqa: E402
from hotstuff_tpu_torch.telemetry.watchtower import Watchtower, WatchtowerConfig  # noqa: E402
from hotstuff_tpu_torch.utils import kernel_build  # noqa: E402
from hotstuff_tpu_torch.utils.serde import Decoder, Encoder  # noqa: E402
from hotstuff_tpu_torch.utils.kernel_times import PROFILER_NAMES, kernel_ms  # noqa: E402

# Where each kernel's TPU counterpart is built (hotstuff_tpu/ops/pallas_msm.py);
# the verdict has none (jnp code in the reference's verify graphs).
SOURCES = {
    "decompress": ("hotstuff_tpu_torch/csrc/decompress.cu", "hotstuff_tpu/ops/pallas_msm.py:248"),
    "sqrt_pow": ("hotstuff_tpu_torch/csrc/sqrt_pow.cu", "hotstuff_tpu/ops/pallas_msm.py:248"),
    "msm_partials_signed": (
        "hotstuff_tpu_torch/csrc/msm_partials.cu",
        "hotstuff_tpu/ops/pallas_msm.py:552",
    ),
    "msm_combine": ("hotstuff_tpu_torch/csrc/msm_combine.cu", "hotstuff_tpu/ops/pallas_msm.py:562"),
    "msm_partials": ("hotstuff_tpu_torch/csrc/msm_partials.cu", "hotstuff_tpu/ops/pallas_msm.py:483"),
    "verdict": ("hotstuff_tpu_torch/csrc/verdict.cu", None),
    # jnp in the reference's sharded verify graphs: ``_combine_partials`` and
    # the verdict after it.
    "verdict_tree": ("hotstuff_tpu_torch/csrc/verdict.cu", "hotstuff_tpu/parallel/mesh.py:55"),
    # No Pallas kernel either: jnp under jax.jit (``_compiled``).
    "sha512": ("hotstuff_tpu_torch/csrc/sha512.cu", "hotstuff_tpu/ops/sha512.py:149"),
}
# The main path's kernels (phase 3), and a warm cached QC's launches (phase 6).
PATH_KERNELS = ("decompress", "msm_partials_signed", "msm_combine", "msm_partials", "verdict")
# The cached path's kernels: the node path's (phase 8) and the data plane's (phase 11).
PHASE8_KERNELS = ("decompress", "msm_partials_signed", "msm_combine", "verdict")
WARM_QC_LAUNCHES = {"decompress": 1, "sqrt_pow": 0, "msm_partials_signed": 2, "msm_partials": 0,
                    "msm_combine": 2, "verdict": 1, "verdict_tree": 0}
# The same beside the digest kernel's count, which a verify leaves at 0.
WARM_QC_ALL = {**WARM_QC_LAUNCHES, "sha512": 0}
# Phase 7's ceiling per warm QC: aten ops the profiler sees, and device ops.
MAX_ATEN_OPS, MAX_DEVICE_OPS = 400, 60
# Every cached-path width (mf, mc) whose kernels were held against their
# plain versions in this run; phases 18 and 19 hold only the widths not in it.
CHECKED_WIDTHS: set[tuple[int, int]] = set()
# The uncached path's lane counts (K1, K4 + K3, its verdict) held likewise.
CHECKED_UNCACHED: set[int] = set()

# The bound. These kernels are bound by int32 multiply-adds (IMAD): a field
# mul is a 20 x 20 limb schoolbook, 400 IMADs. A Hopper SM issues 64 int32
# lanes per clock (NVIDIA's Hopper white paper), so the card's IMAD peak is
# SMs x 64 x its maximum SM clock. Bytes: each input read once, each output
# written once, over 3.35 TB/s (H100 SXM data sheet).
IMAD_PER_MUL = 400
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
MULS_PADD, MULS_PDOUBLE, MULS_SQRT_POW = 9, 8, 269
# A decompressed lane: y^2 and d y^2, the root, r^2 v, x y. A lane whose
# root is fixed by sqrt(-1) takes one more, left out: the bound is at most
# 1/275 low, which does not flatter the kernel.
MULS_DECOMPRESS = 2 + MULS_SQRT_POW + 2 + 1
# K3's serial chain, in field muls that each wait for the one before: a
# point add's muls run in 3 dependent stages ({a, b, T 2d, 2Z Z'}, then
# (T 2d) T', then the four products), a doubling's in 2.
STAGES_PADD, STAGES_PDOUBLE = 3, 2

# The smoke configuration: BASELINE.json config 4, a 1000-validator
# committee (stake 1 each, quorum 667), at its full width.
VALIDATORS = 1000
ROUNDS = 3
# Phase 8's view change: the round its timeouts and TC are for.
TC_ROUND = ROUNDS + 2
# Phase 9's committee: BASELINE.json config 2 (a 100-node single-host
# committee, QC batch verification on one card), the shape of the
# reference's ``benchmark/committee_scale.py --mode protocol``.
COMMITTEE_N = 100
COMMITTEE_ROUNDS = 10
COMMITTEE_TRACED_ROUNDS = 3
COMMITTEE_TIMEOUT_MS = 30_000
# Base ports of the card's committee, the CPU yardsticks' (serial, then the
# RLC engine) and the profiled card committee's: below the ephemeral ranges of the hosts it ran on
# (Linux's default 32768-60999, and 16000-65535 on an H100 host), so that no
# outgoing connection of an engine spawned earlier holds a later engine's
# port.
COMMITTEE_PORTS = (10000, 10200, 10100, 10800)
# Seconds allowed for the first commit everywhere, and for each round after.
COMMITTEE_BOOT_S, COMMITTEE_ROUND_S = 75.0, 20.0
# The profiler's stage tags: the core's stage seeds, the round trace's
# marks and the crypto bridge's worker tag (reference
# ``hotstuff_tpu/consensus/core.py:905-922``, ``telemetry/spans.py``).
STAGE_TAGS = ("ingress", "fanin", "verify", "vote", "view_change", "idle", "other")

# Phase 10a/b: the reference digest test's lengths and the two-block
# boundary, and the reference digest bench's grid (benchmark/
# digest_bench.py:56-57): drains of 8, 32 and 128 batches of 512 B, 15 kB
# and 500 kB.
SHA_LENGTHS = (0, 1, 32, 96, 111, 112, 127, 128, 239, 240, 300)
DIGEST_DRAINS, DIGEST_SIZES = (8, 32, 128), (512, 15_000, 500_000)
# The int32 instructions of one 128-byte SHA-512 block a lane (the model of
# csrc/sha512.cu's note): 80 rounds of 28 (Sigma1 and Sigma0 three rotates
# each at two funnel shifts a rotate and two LOP3s for the xors, ch and maj
# two LOP3s each, t1 as two 3-term adds and a = t1 + Sigma0 + maj and
# e = d + t1 one each, an IADD3 and an IADD3.X a 64-bit add), 64 schedule
# steps of 20 (sigma0 and sigma1 two rotates and a shift of two SHFs each
# plus two LOP3s, then two 3-term adds), the feed-forward's 8 adds, and two
# byte swaps (PRMT) a loaded word. All on the int32 pipe, taken at the
# IMAD rate below (64 a clock an SM).
SHA512_INT_OPS_PER_BLOCK = 80 * 28 + 64 * 20 + 8 * 2 + 16 * 2
# The chain floor: a lane's rounds are a dependent chain, block after
# block, whatever the instruction rate. csrc/sha512.cu's round has 4
# instructions on the e-chain (SHF, LOP3, IADD3, IADD3.X); each waits for
# the one before, taken at 4 cycles (the dependent-issue latency of the
# int32 pipe's fixed-latency instructions on Volta to Hopper, as published
# microbenchmarks give it; not measured here). At the maximum SM clock:
# the longest lane's blocks x 80 x 4 x 4 cycles.
SHA512_CHAIN_DEPENDENT_OPS, INT32_DEPENDENT_CYCLES = 4, 4
# The chain warp's issue floor: it runs alone on its scheduler, whose int32
# pipe is 16 lanes wide (INT32_LANES_PER_SM / 4), so each of its warp
# instructions holds the pipe 2 cycles. Its 8-round loop holds 224 SHF,
# LOP3 and IADD3 in the SASS of csrc/sha512.cu (28 a round; a few more
# adds go to the FMA pipe as IMAD.X): the longest lane's blocks x 80 x 28
# x 2 cycles.
SHA512_CHAIN_ALU_OPS, INT32_WARP_CYCLES = 28, 2
# Phase 10a's added drains (lane counts around a CTA's 32, ragged lanes in
# one CTA) and phase 10b's added rows: the verifier's challenge hashes,
# the node path's drains of 2 and 3 batches, and 18 x 15,485 B, the widest
# drain config 1 had given the kernel when these rows were chosen.
SHA_LANE_COUNTS = (1, 31, 32, 33, 129)
SHA_NODE_ROWS = ((1024, 96), (2, 15_000), (3, 15_000), (18, 15_485))
# Phase 10c: BASELINE.json config 1, the reference's ``fab local`` setting
# (benchmark/local.py:46-53, benchmark/fabfile.py:24-29): 4 nodes, timeout
# 1 s, 15 kB batches sealed at 10 ms at the latest, 1000 tx/s of 512 B
# over four clients. Ports 10300-10329: consensus, then transactions, then
# mempool, below the H100 host's ephemeral range and clear of phase 9's.
NODE_N, NODE_PORTS = 4, 10300
NODE_TIMEOUT_MS, NODE_BATCH_BYTES, NODE_BATCH_DELAY_MS = 1_000, 15_000, 10
NODE_RATE, NODE_TX_BYTES = 1_000, 512
# Seconds (phases 10c and 11): for the first payload commit on every node,
# the measured window, the tail after the clients stop, and how long before
# the window's end a sample must have been sent to be required in a
# committed batch.
NODE_BOOT_S, NODE_WINDOW_S, NODE_DRAIN_S, NODE_SAMPLE_SLACK_S = 30.0, 10.0, 2.5, 1.0
PHASE10_KERNELS = ("sha512", "decompress", "msm_partials_signed", "msm_combine", "verdict")
# Phase 11: the data plane (Conveyor) at the README's configuration and the
# reference sweep's defaults (README.md:107, benchmark/dataplane_sweep.py:
# 150-160): 4 nodes with 2 workers each, 512 B transactions, 250,000 B
# batches sealed at 50 ms at the latest, timeout 2 s, 20,000 tx/s offered
# (the sweep's gate rate, dataplane_sweep.py:21) over four sharded clients,
# each to its node's two worker ingress ports. Ports in benchmark/local.py's
# layout (:161-172) from 10400: consensus, transactions, mempool, then each
# worker's ingress and peer port, four a kind.
CONVEYOR_N, CONVEYOR_WORKERS, CONVEYOR_PORTS = 4, 2, 10400
CONVEYOR_TIMEOUT_MS, CONVEYOR_BATCH_BYTES, CONVEYOR_BATCH_DELAY_MS = 2_000, 250_000, 50
CONVEYOR_RATE, CONVEYOR_TX_BYTES = 20_000, 512
# Seconds after the clients stop for what they sent to commit: longer than
# phase 10c's, since a batch here waits for more rounds (end-to-end p95
# 0.7-1.6 s on the H100 hosts seen, against 0.06-0.2 s in config 1).
CONVEYOR_DRAIN_S = 5.0
# Phase 12: replica rejoin. a: the reference's real-plane scenario
# (benchmark/scenarios/rejoin.json, as tests/test_statesync_sim.py:97-120
# runs it; defaults of hotstuff_tpu/faultline/harness.py:70-81): 4 engines,
# timeout 1 s, batched vote verification, retention 16; engine 1 crashes
# uncleanly 2 s after the first commit everywhere and restarts wiped at
# 8 s; it must commit 3 blocks within 30 s of the restart. b: config 1
# (phase 10c) at retention 16, node 2 crashing after the first payload
# commit everywhere and restarting 3 s later on its own store, then a
# window of 8 s. c: the snapshot check at phase 3's N = 1000. Ports
# 10500-10503 (a) and 10510-10539 (b, in phase 10c's layout).
REJOIN_N, REJOIN_PORTS, REJOIN_RETENTION, REJOIN_VICTIM = 4, 10500, 16, 1
REJOIN_CRASH_S, REJOIN_RESTART_S, REJOIN_RECOVERY_S, REJOIN_COMMITS = 2.0, 8.0, 30.0, 3
WARM_PORTS, WARM_VICTIM, WARM_DOWN_S, WARM_WINDOW_S = 10510, 2, 3.0, 8.0
PHASE12_KERNELS = ("decompress", "msm_partials_signed", "msm_combine", "verdict")
# Phase 13: the sharded verifier. 13a holds the tree-combine verdict at
# these shard counts; 13b verifies phase 3's QC on meshes of the one card
# repeated this many times, and of three shards (an odd width, where the
# reference's combine drops a shard).
TREE_WIDTHS = (1, 2, 3, 4, 6, 8)
MESH_WIDTHS = (1, 2, 3, 4, 8)
# Phase 15: the reference's committed fault scenarios (read as data, by
# path) through the port's faultline on committees under cuda-batched, at
# the harness's default timeout of 1 s (hotstuff_tpu/faultline/
# harness.py:76). a: rejoin.json at N = 4 and retention 16 (as
# tests/test_statesync_sim.py runs it); b: storm-n20.json at N = 20,
# committee_scale's default size; c: an 8 s scenario with no events at
# N = 4 streamed to the watchtower; d: phase 11's data plane with node 2
# withholding its acks from 2 s to 8 s of a 10 s scenario. Ports
# 11000-11199: below the H100 host's ephemeral range, clear of phase 9's
# profiled run (10800-10899) and of the card tests (10700-10747,
# 10900-10931).
SCENARIO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmark", "scenarios")
FAULT_RUNS = (  # (scenario file, N, base port, retention rounds)
    ("rejoin.json", 4, 11030, 16),
)
STORM_RUN = ("storm-n20.json", 20, 11050, 0)
QUIET_PORTS, WITHHOLD_PORTS, FAULT_TIMEOUT_MS = 11040, 11100, 1_000
# Scenarios whose faults cut links: each must count dropped frames.
DROPPING = ("partition.json", "storm-n20.json")
FAULT_KERNELS = ("decompress", "msm_partials_signed", "msm_combine", "verdict")
# Phase 16: the native plane, in a child process started with these
# variables (both read at import: the transport switch by the network
# package, the bridge's worker count by the crypto bridge, as
# benchmark/committee_scale.py:467 sets it for protocol mode). a: phase 9's
# committee (BASELINE config 2); b: BASELINE config 4 in protocol mode,
# N = 1000 (f = 333, quorum 667), 5 timed rounds where committee_scale's
# default is 20 (the one cut, to keep the run under 15 minutes); c: phase 10c's
# config 1 on native stores; d: phase 15a's partition.json. Ports
# 11200-11499 and 12000-12999: below the H100 host's ephemeral range, clear
# of the other phases and of the card tests.
NATIVE_ENV = {"HOTSTUFF_NET": "native", "HOTSTUFF_CRYPTO_WORKERS": "32",
              "HOTSTUFF_CERT_ARENA": "1"}
NATIVE_N100_PORTS, NATIVE_NODE_PORTS, NATIVE_FAULT_PORTS = 11200, 11300, 11400
NATIVE_N, NATIVE_PORTS, NATIVE_ROUNDS = 1000, 12000, 5
NATIVE_TIMEOUT_S = 480
NATIVE_RESULT = "phase 16 result: "
# Phase 17: engine groups, the committee sharded over worker processes
# (``parallel/engine_groups.py``, started by spawn), each group with the
# environment of phase 16's child and the cuda-batched backend. a: BASELINE
# config 2's shape (N = 100, 4 groups, 10 timed rounds); b: config 4 in
# protocol mode as ``committee_scale.py --mode protocol --nodes 1000
# --groups 8`` runs it, 5 timed rounds where its default is 20 (the one
# cut, as 16b). Ports 13000-13099 and 13100-14099: below the H100 host's
# ephemeral range, clear of phases 9-16. c: the sim plane through the
# port's ``sim_sweep --seeds 0:300 --twins 24 --inject-wedge --gate`` and
# ``detector_sweep --config preset:tuned-n4 --gate`` (each sets the cpu
# backend for itself).
GROUP_ENV = {**NATIVE_ENV, "HOTSTUFF_CRYPTO_BACKEND": "cuda-batched"}
GROUPS_N100 = (100, 4, 13000, 10)  # N, groups, base port, timed rounds
GROUPS_N1000 = (1000, 8, 13100, 5)
GROUP_BOOT_S, GROUP_ROUNDS_S = 90.0, 120.0
SIM_SEEDS, SIM_TWINS = 300, 24
# 17c's detector sweep: chaos seeds, single-fault seeds a class, controls.
DETECTOR_SWEEP = (60, 10, 10)
TUNED_N4 = "e9e99f16bffb"  # the tuned watchtower preset's fingerprint


# Phase 18: the port's copies of the reference's benchmark scripts
# (``hotstuff_tpu_torch/benchmark/``), through the command lines a user
# types. a: ``committee_scale --mode crypto`` at BASELINE config 3 (N = 400),
# config 4 (N = 1000) and config 4's view-change regime (``--tc-heavy``), the
# script's default 20 rounds, with the cert arena off so that every round
# pays its verifies; b: ``--mode protocol`` at N = 100 (config 2's shape) on
# the native transport, profiled; c: ``digest_bench``'s default grid; d:
# ``superbatch_bench``'s defaults; e: ``run_local`` at BASELINE config 1.
# Ports 14100-14199 (b) and 14300-14319 (e): below the H100 host's
# ephemeral range, clear of the other phases.
REPO = os.path.dirname(os.path.abspath(__file__))
HARNESS_CRYPTO = ((400, False), (1000, False), (1000, True))  # N, --tc-heavy
HARNESS_ROUNDS = 20
HARNESS_PROTOCOL = (100, 10, 14100)  # N, rounds, base port
HARNESS_LOCAL = (4, 1000, 5, 14300)  # nodes, tx/s, seconds, base port
HARNESS_TIMEOUT_S = 300
# Phase 19: the data-plane and robustness harness through its command lines.
# a: ``dataplane_sweep`` at phase 11's Conveyor setting (4 nodes x 2 workers,
# 20,000 tx/s) as separate node processes, with lifelines; b: ``fleet_bench``,
# the first example of the reference's docstring; c: ``soak`` under chaos
# seed 7 judged with the tuned watchtower preset; d: ``fault_matrix`` at
# N = 20 on both transport planes, its 12 s cut to 8, beside its ``run_plane``
# in this process with the launches counted. Ports 14400-14427 (a),
# 14800-14827 (b), 15200-15211 (c), 15400-15491 (d's children) and
# 15500-15591 (d here): below the H100 host's ephemeral range, clear of
# phases 9-18.
DATAPLANE_SWEEP = (4, 2, 20_000, 6, 14400)  # nodes, workers, tx/s, seconds, base port
FLEET = (4, 2, 20_000, 256, 8, 6, 14800)  # nodes, workers, tx/s, fleet, bundle txs, s, port
SOAK = (4, 500, 30, 7, 15200)  # nodes, tx/s, seconds, chaos seed, base port
SOAK_ALLOWED = 0.34  # the script's default --allow-violation-fraction
# N, seconds of the command line's run, base port (children), seconds and base
# port of the run here
FAULT_MATRIX = (20, 8.0, 15400, 4.0, 15500)
# Phase 20: the measurement tools through their command lines. a: ``regress``
# (the committee at its default N = 40 and 12 rounds, 2 repeats, under
# ``cuda-batched``; then its crypto check) against the card's committed
# baselines; b: the three smoke gates at N = 10, 2 repeats (the reference's
# defaults are 3); c: ``profile_device`` at the bench's width in this process;
# d: ``sample_profile`` (10 rounds of its 15), ``diag_protocol`` (10 s of its
# 60) and ``profile_protocol`` (5 s of its 20) under ``cuda-batched``; e:
# ``dtrace_smoke`` (2 repeats of its 3) and ``netplane_frames``, which make no
# card call, beside phases 3-5. Ports, below the H100 host's ephemeral range
# and clear of phases 9-19: a 15600-15759; b 14200-14299, 14828-14927 and
# 14928-15027 (each leg 2 N); d 15028-15067, 15068-15107, and 15760-15763,
# 15860-15863, 15960-15963; e 14428-14791 (four legs a hundred apart, each
# binding base + 40 to base + 63) and 14321-14326.
REGRESS = (40, 12, 2, 15600)  # N, rounds, repeats, base port
REGRESS_BASELINES = ("committee-protocol-cuda-batched-40.txt", "bench-torch-1343-h100.json")
SMOKES = (("telemetry_smoke", 14200), ("profile_smoke", 14828), ("watchtower_smoke", 14928))
SMOKE_NODES, SMOKE_REPEATS = 10, 2
PROFILE_DEVICE_SIGS = 1343
# Each stage of profile_device, and what one of its calls launches.
PROFILE_STAGES = {
    "full_pipeline": {"decompress": 1, "msm_partials": 1, "msm_combine": 1, "verdict": 1},
    "unpack": {},
    "decompress(all)": {"decompress": 1},
    "sqrt_pow_only": {"sqrt_pow": 1},
    "msm": {"msm_partials": 1, "msm_combine": 1},
    "cofactor_check": {"verdict": 1},
    "kernelA_partials": {"msm_partials": 1},
    "kernelB_combine": {"msm_combine": 1},
}
SAMPLE_PROFILE = (40, 10, 15028)  # N, rounds, base port
DIAG_PROTOCOL = (40, 10, 15068)  # N, seconds, base port
PROFILE_PROTOCOL = (5, 15760)  # seconds, base port
DTRACE_SMOKE = (2, 14428)  # repeats, base port
NETPLANE = ("1024,65536,396288", 200, 14320)  # sizes, frames, base port
# Phase 21: the README's crash-fault quick start through the port's CLI,
# ``fabfile local --nodes 4 --faults 1 --rate 600 --duration 5 --save`` (5 s
# of the README's 20, a cut), in a working directory of its own. ``local``
# has no ``--base-port``: ``LocalBench``'s 9000-9011 (three blocks of four),
# kept 9000-9015, below the H100 host's ephemeral range and clear of phases
# 9-20.
FABFILE_LOCAL = (4, 1, 600, 5)  # nodes, faults, tx/s, seconds
SMOKE_SUMMARY = re.compile(r'\{"metric": ".*\}')
COMMITTEE_LINE = re.compile(
    r"committee=(?P<n>\d+) \(f=(?P<f>\d+), QC size (?P<q>\d+)\) mode=(?P<mode>\w+)"
    r"(?P<tc> tc-heavy)?(?: groups=\d+)? backend=(?P<backend>\S+) transport=(?P<transport>\w+): "
    r"(?P<ms>[\d.]+) ms/round \((?P<rps>[\d.]+) rounds/s\)")
SUPERBATCH_FUSION = re.compile(r"fusion: (?P<requests>\d+) requests in (?P<calls>\d+) inner calls")
SUMMARY_FIGURE = re.compile(r" (?P<what>Consensus TPS|Consensus latency|End-to-end TPS|"
                            r"End-to-end latency): (?P<value>[\d,]+) (?:tx/s|ms)")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def reset_launches() -> None:
    """Every kernel's launch count to 0: the QC kernels' and the digest's."""
    mk.reset_launches()
    sha.LAUNCHES["sha512"] = 0


def launch_counts() -> dict:
    return {**mk.LAUNCHES, **sha.LAUNCHES}


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_usage() -> dict[str, tuple[int, int, int]]:
    """(registers, stack bytes, spill store bytes) of each kernel, by its
    ``PROFILER_NAMES`` key, from ptxas' report in the build log."""
    mangled = {"decompress": "decompress_kernel",
               "sqrt_pow": "sqrt_pow_kernel", "msm_partials_signed": "msm_partials_kernelILb1",
               "msm_partials": "msm_partials_kernelILb0", "msm_combine": "msm_combine_kernel",
               "verdict": "verdict_kernel", "verdict_tree": "verdict_tree_kernel",
               "sha512": "sha512_kernel"}
    usage, current = {}, None
    for _, log in kernel_build.build_log.values():
        for line in log.splitlines():
            if "Compiling entry function" in line:
                current = next((k for k, m in mangled.items() if m in line), None)
            elif current and "bytes stack frame" in line:
                words = line.split()
                stack, spill = int(words[0]), int(words[4])
            elif current and "Used" in line and "registers" in line:
                regs = int(line.split("Used")[1].split()[0])
                usage[current] = (regs, stack, spill)
                current = None
    return usage


def bound_ms(muls: int, nbytes: int, imad_per_s: float) -> tuple[float, str]:
    t_ops = muls * IMAD_PER_MUL / imad_per_s
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max())


# -- phase 3: the main path ----------------------------------------------------


def make_committee(n: int, seed: int):
    rng = random.Random(seed)
    keys = [crypto.generate_keypair(seed=rng.randbytes(32)) for _ in range(n)]
    committee = Committee({pk: Authority(1, ("127.0.0.1", 9000 + i)) for i, (pk, _) in enumerate(keys)})
    return keys, committee


def make_qc(keys, committee, round_: int, seed: int) -> QC:
    """Signed votes of a shuffled committee into the aggregator until the
    QC forms (at 2f+1 by stake)."""
    rng = random.Random(seed * 1000 + round_)
    block = crypto.sha512_digest(b"block", seed.to_bytes(8, "little"), round_.to_bytes(8, "little"))
    agg = Aggregator(committee)
    order = list(keys)
    rng.shuffle(order)
    for pk, sk in order:
        qc = agg.add_vote(Vote.new_from_key(block, round_, pk, sk))
        if qc is not None:
            return qc
    raise SmokeFailure("no QC formed")


def tampered(qc: QC) -> QC:
    votes = list(qc.votes)
    pk, sig = votes[len(votes) // 2]
    data = bytearray(sig.data)
    data[5] ^= 0x01  # inside R: host checks pass, the device equation fails
    votes[len(votes) // 2] = (pk, crypto.Signature(bytes(data)))
    return QC(hash=qc.hash, round=qc.round, votes=votes)


def main_path(keys, committee, qcs):
    """Drive the port's entry points; returns (launch counts, timings)."""
    reset_launches()
    t0 = time.perf_counter()
    backend = CudaBackend()
    crypto.set_backend(backend)
    first_ms = []
    for qc in qcs:
        t = time.perf_counter()
        qc.verify(committee)  # raises on rejection
        first_ms.append((time.perf_counter() - t) * 1e3)
    try:
        tampered(qcs[0]).verify(committee)
        raise SmokeFailure("tampered QC accepted")
    except errors.InvalidSignature:
        pass
    try:
        QC(qcs[0].hash, qcs[0].round, qcs[0].votes[: len(qcs[0].votes) - 1]).verify(committee)
        raise SmokeFailure("QC below quorum accepted")
    except errors.QCRequiresQuorum:
        pass
    crypto.set_backend(CudaBackend(cache=False))
    t = time.perf_counter()
    qcs[-1].verify(committee)
    uncached_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    crypto.set_backend(backend)
    check(backend.dispatches == len(qcs) + 1, f"backend dispatches {backend.dispatches}")
    return launches, backend, {"first_ms": first_ms, "uncached_ms": uncached_ms, "wall_s": wall}


# -- phase 4: small input against the oracle ----------------------------------


def oracle_check(device) -> None:
    rng = random.Random(7)
    points, scalars = [], []
    for _ in range(4):
        k = rng.randrange(1, ref.L)
        points.append(ref.point_mul(k, ref.G))
        scalars.append(rng.randrange(0, ref.L))
    expected = ref.IDENTITY
    for pt, s in zip(points, scalars):
        expected = ref.point_add(expected, ref.point_mul(s, pt))
    arr = np.stack(
        [np.stack([fe._int_to_limbs(c % fe.P) for c in pt]) for pt in points]
    ).astype(np.int32)
    pts = torch.from_numpy(arr).to(device)
    signed = torch.from_numpy(cv.scalars_to_signed_digits(scalars, 64).copy()).to(device)
    unsigned = torch.from_numpy(cv.scalars_to_digits(scalars)).to(device)
    want = ref.point_compress(expected)
    check(cv.to_affine_bytes(mk.msm_signed(pts, signed)) == want, "signed MSM != oracle")
    check(cv.to_affine_bytes(mk.msm(pts, unsigned)) == want, "unsigned MSM != oracle")


# -- phase 5: kernels against plain versions ----------------------------------


def usage_note(name: str) -> str:
    regs, stack, spill = ptxas_usage()[name]
    return f"{regs} registers, {stack} B stack, {spill} B spill stores"


def with_invalid_rows(y: torch.Tensor, sign: torch.Tensor):
    """Copies of a batch's y limbs and signs with its last three lanes (the
    padding of a QC's batch) made invalid: a non-square y = 2, y = 1 (x = 0)
    with sign 1, and y = p - 1 (x = 0, top limb full) with sign 1."""
    y, sign = y.clone(), sign.clone()
    for i, (val, s) in enumerate([(2, 0), (1, 1), (fe.P - 1, 1)]):
        y[-1 - i] = torch.from_numpy(fe._int_to_limbs(val)).to(y.device)
        sign[-1 - i] = s
    return y, sign


def qc_batch(qc: QC):
    """A QC's (msgs, pubs, sigs), as ``QC.verify`` hands them to the backend."""
    digest = qc.digest().data
    return [digest] * len(qc.votes), [pk.data for pk, _ in qc.votes], [sig.data for _, sig in qc.votes]


def kernel_checks(batch, backend, device, imad_per_s: float, uncached: bool = True,
                  curve_msm: bool = False):
    """Each kernel against its plain version on the inputs that verifying
    ``batch`` (msgs, pubs, sigs) gives it, timed, with its bound. The
    cached path's kernels always; with ``uncached``, also the uncached
    path's (K1 over every lane, K4 + K3, its verdict) and the root alone;
    with ``curve_msm`` (phase 5), also each full MSM against the plain
    curve MSM."""
    msgs, pubs, sigs = batch
    packed, mf, mc = ov.prepare_batch_cached(msgs, pubs, sigs, backend._cache)
    packed_d = torch.from_numpy(packed).to(device)
    ok_f, pts_f, digits_f, pts_c, digits_c = ov.cached_inputs(packed_d, backend._cache.array, mf)
    fresh = packed_d[:mf].to(torch.int32)
    y_f, sign_f = ov._enc_to_y_limbs(fresh[:, :32]), fresh[:, 65]
    digits_f, digits_c = digits_f.contiguous(), digits_c.contiguous()
    decompress_cases, msm_cases = [(y_f, sign_f)], [("signed", pts_f, digits_f, True),
                                                    ("signed", pts_c, digits_c, True)]
    m_u = None
    if uncached:
        packed_u, m_u = ov.prepare_batch(msgs, pubs, sigs)
        packed_ud = torch.from_numpy(packed_u).to(device)
        ok_u, pts_u, digits_u = ov.uncached_inputs(packed_ud)
        y_u, sign_u = ov._unpack_device(packed_ud)[:2]
        decompress_cases.append((y_u, sign_u))
        msm_cases.append(("unsigned", pts_u, digits_u, False))
    torch.cuda.synchronize()

    rows, notes = {}, []
    t_checks, spent = time.perf_counter(), {"plain": 0.0, "whole": 0.0}

    def timed_plain(fn, part: str = "plain"):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        spent[part] += time.perf_counter() - t
        return out, (time.perf_counter() - t) * 1e3

    # K1, the decompression: at the fresh R lanes of the cached batch and at
    # every lane of the uncached batch, each with invalid rows.
    for y, sign in decompress_cases:
        y, sign = with_invalid_rows(y, sign)
        m = y.shape[0]
        ok_k, pts_k = mk.decompress(y, sign)
        (ok_p, pts_p), plain = timed_plain(lambda: mk.decompress_plain(y, sign))
        err = max_abs_err(pts_k, pts_p)
        check(err == 0, f"decompress [{m}] points differ from the plain version by {err}")
        check(torch.equal(ok_k, ok_p), f"decompress [{m}] ok differs from the plain version")
        check(not ok_k[-3:].any() and bool(ok_k[:-3].all()),
              f"decompress [{m}]: the invalid rows passed or a valid one failed")
        b, by = bound_ms(MULS_DECOMPRESS * m, m * (80 + 4 + 1 + 320), imad_per_s)
        ms, ev, pr = kernel_ms(lambda: mk.decompress(y, sign), 20, PROFILER_NAMES["decompress"])
        grid, threads = mk.decompress_geometry(m)
        notes.append(f"decompress y [{m}, 20]: grid {grid} x {threads} threads, "
                     f"{usage_note('decompress')}; {ms:.4f} ms (events {ev:.4f}, profiler {pr:.4f}; "
                     f"plain {plain:.1f} ms, bound {b:.4f} ms)")
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                   shape=f"y [{m}, 20]")
        # The JSON row: the cached QC's shape, one launch a QC; the uncached
        # batch's beside it.
        rows["decompress" if m == mf else "decompress_uncached"] = row

    # The root alone, off the path since the decompression took it in.
    if uncached:
        u, v = cv.decompress_ratio(y_f)
        m = u.shape[0]
        r_k = mk.sqrt_pow(u, v)
        r_p, plain = timed_plain(lambda: mk.sqrt_pow_plain(u, v))
        err = max_abs_err(r_k, r_p)
        check(err == 0, f"sqrt_pow differs from its plain version by {err}")
        check(bool((fe.canonical(r_k) == fe.canonical(r_p)).all()), "sqrt_pow canonical mismatch")
        b, by = bound_ms(MULS_SQRT_POW * m, 3 * m * 80, imad_per_s)
        ms, ev, pr = kernel_ms(lambda: mk.sqrt_pow(u, v), 20, PROFILER_NAMES["sqrt_pow"])
        rows["sqrt_pow"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                                shape=f"u, v [{m}, 20]")
        blocks = -(-m // mk.SQRT_POW_BLOCK)
        notes.append(f"sqrt_pow u, v [{m}, 20]: grid ({blocks}, 1) x {min(mk.SQRT_POW_BLOCK, m)} "
                     f"threads, {usage_note('sqrt_pow')}; {ms:.4f} ms (events {ev:.4f}, profiler "
                     f"{pr:.4f}; plain {plain:.1f} ms, bound {b:.4f} ms)")

    # K2 + K3 (signed) at both window counts; K4 + K3 (unsigned).
    for kind, pts, digits, signed in msm_cases:
        m, w = pts.shape[0], digits.shape[0]
        block = min(mk.PARTIALS_BLOCK, m)
        nb = m // block
        part_k = mk.msm_partials(pts, digits, signed=signed)
        part_p, part_plain = timed_plain(lambda: mk.msm_partials_plain(pts, digits, block, signed))
        err_p = max_abs_err(part_k, part_p)
        check(err_p == 0, f"{kind} partials ({w} windows) differ from plain by {err_p}")
        out_k = mk.msm_combine(part_k)
        out_p, comb_plain = timed_plain(lambda: mk.msm_combine_plain(part_k))
        err_c = max_abs_err(out_k, out_p)
        check(err_c == 0, f"combine ({w} windows) differs from plain by {err_c}")
        if curve_msm:
            whole = cv.msm_signed if signed else cv.msm
            ref_pt, _ = timed_plain(lambda: whole(pts, digits), "whole")
            check(cv.to_affine_bytes(out_k) == cv.to_affine_bytes(ref_pt),
                  f"{kind} MSM ({w} windows, m={m}) != plain curve MSM")
        table = 9 if signed else 16
        pname = "msm_partials_signed" if signed else "msm_partials"
        p_ms, p_ev, p_pr = kernel_ms(lambda: mk.msm_partials(pts, digits, signed=signed), 10,
                                     PROFILER_NAMES[pname])
        c_ms, c_ev, c_pr = kernel_ms(lambda: mk.msm_combine(part_k), 10,
                                     PROFILER_NAMES["msm_combine"])
        pb, pby = bound_ms(
            MULS_PADD * (m * (table - 2) + nb * w * (block - 1)),
            m * 320 + w * m * 4 + nb * w * 320, imad_per_s,
        )
        cb, cby = bound_ms(
            MULS_PADD * w * (nb - 1) + (w - 1) * (4 * MULS_PDOUBLE + MULS_PADD),
            nb * w * 320 + 320, imad_per_s,
        )
        p_grid, p_threads = mk.partials_geometry(m, w, block)
        c_grid, c_threads = mk.combine_geometry(w)
        notes.append(
            f"{pname} points [{m}, 4, 20], digits [{w}, {m}]: grid {p_grid} x {p_threads} "
            f"threads, {usage_note(pname)}; {p_ms:.4f} ms (events {p_ev:.4f}, profiler "
            f"{p_pr:.4f}; plain {part_plain:.1f} ms, bound {pb:.4f} ms)"
        )
        chain = (nb - 1) * STAGES_PADD + (w - 1) * (4 * STAGES_PDOUBLE + STAGES_PADD)
        notes.append(
            f"msm_combine partials [{nb}, {w}, 4, 20]: grid {c_grid} x {c_threads} threads, "
            f"{usage_note('msm_combine')}; {c_ms:.4f} ms (events {c_ev:.4f}, profiler "
            f"{c_pr:.4f}; plain {comb_plain:.1f} ms, bound {cb:.4f} ms; serial chain {chain} "
            f"dependent mul stages, {c_ms * 1e6 / chain:.0f} ns each)"
        )
        # The JSON row of each kernel is taken at its widest main-path shape:
        # K2 and K3 at the cached lanes' 64 windows, K4 at the uncached batch.
        if w == 64 and (pname not in rows):
            rows[pname] = dict(max_abs_err=err_p, ms=p_ms, plain_ms=part_plain, bound_ms=pb,
                               bound_by=pby, shape=f"points [{m}, 4, 20], digits [{w}, {m}]")
        if signed and w == 64:
            rows["msm_combine"] = dict(max_abs_err=err_c, ms=c_ms, plain_ms=comb_plain,
                                       bound_ms=cb, bound_by=cby,
                                       shape=f"partials [{nb}, {w}, 4, 20]")
    # The verdict: the cached QC's two MSM results and the uncached one's,
    # then rejections (one point alone, an ok with one False in its last
    # lane), each against the plain version.
    acc_f, acc_c = mk.msm_signed(pts_f, digits_f), mk.msm_signed(pts_c, digits_c)
    ok_last_false = ok_f.clone()
    ok_last_false[-1] = False
    cases = [
        ("cached", ok_f, (acc_f, acc_c), True),
        ("one MSM of two", ok_f, (acc_f,), False),
        ("ok with one False", ok_last_false, (acc_f, acc_c), False),
    ]
    if uncached:
        cases.insert(1, ("uncached", ok_u, (mk.msm(pts_u, digits_u),), True))
    for name, ok, pts, want in cases:
        got = mk.verdict(ok, *pts)
        plain_v, plain = timed_plain(lambda: mk.verdict_plain(ok, *pts))
        err = abs(int(got) - int(plain_v))
        check(err == 0 and bool(got) == want,
              f"verdict ({name}): kernel {bool(got)}, plain {bool(plain_v)}, expected {want}")
        if name not in ("cached", "uncached"):
            continue
        m = ok.shape[0]
        muls = (MULS_PADD if len(pts) == 2 else 0) + 3 * MULS_PDOUBLE
        b, by = bound_ms(muls, m + 320 * len(pts) + 1, imad_per_s)
        ms, ev, pr = kernel_ms(lambda: mk.verdict(ok, *pts), 20, PROFILER_NAMES["verdict"])
        chain = (STAGES_PADD if len(pts) == 2 else 0) + 3 * STAGES_PDOUBLE
        notes.append(f"verdict ok [{m}], {len(pts)} point(s): grid (1, 1) x 128 threads, "
                     f"{usage_note('verdict')}; {ms:.4f} ms (events {ev:.4f}, profiler {pr:.4f}; "
                     f"plain {plain:.1f} ms, bound {b:.6f} ms; serial chain {chain} dependent "
                     f"mul stages)")
        if name == "cached":
            rows["verdict"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                                   shape=f"ok [{m}], a, b [4, 20]")
    CHECKED_WIDTHS.add((mf, mc))
    if uncached:
        CHECKED_UNCACHED.add(m_u)
    notes.append(f"these checks {time.perf_counter() - t_checks:.1f} s: plain versions "
                 f"{spent['plain']:.1f} s" + (f", plain curve MSMs {spent['whole']:.1f} s"
                                             if curve_msm else ""))
    return rows, notes, (mf, mc, m_u)


# -- phase 6: warm QC timing ---------------------------------------------------


def qc_timing(qcs, committee, backend, device, reps: int):
    wall, host, span = [], [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(reps):
        for qc in qcs:
            torch.cuda.synchronize()
            t = time.perf_counter()
            qc.verify(committee)
            wall.append((time.perf_counter() - t) * 1e3)
            msgs, pubs, sigs = qc_batch(qc)
            t = time.perf_counter()
            packed, mf, _ = ov.prepare_batch_cached(msgs, pubs, sigs, backend._cache)
            host.append((time.perf_counter() - t) * 1e3)
            start.record()
            ok = ov.run_cached(torch.from_numpy(packed).to(device), backend._cache.array, mf)
            end.record()
            check(bool(ok), "warm QC rejected")
            span.append(start.elapsed_time(end))
    return float(np.median(wall)), float(np.median(host)), float(np.median(span))


# -- phase 7: where the time goes ----------------------------------------------


def device_times(prof) -> tuple[dict[str, list[float]], int]:
    """The profiler's device ops' durations (ms) by name, and its count of
    aten ops on the host."""
    from torch.autograd import DeviceType

    by_name: dict[str, list[float]] = {}
    host_ops = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name, []).append((e.time_range.end - e.time_range.start) / 1e3)
        elif e.name.startswith("aten::"):
            host_ops += 1
    return by_name, host_ops


def profile_qc(qc: QC, committee, reps: int) -> tuple[list[str], float, float]:
    """Trace ``reps`` warm verifies of one QC; per QC: wall (profiler on),
    device busy time, and device time and count by kernel name. Also
    returns the aten ops and the device ops per QC."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            qc.verify(committee)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / reps
    by_name, host_ops = device_times(prof)
    h2d = sum(len(d) for name, d in by_name.items() if "HtoD" in name) / reps
    busy = sum(sum(d) for d in by_name.values()) / reps
    launches = sum(len(d) for d in by_name.values()) / reps
    check(busy > 0, "the profiler saw no device time")
    lines = [f"profile ({reps} warm QC.verify, profiler on): wall {wall_ms:.2f} ms per QC, device "
             f"time (profiler busy) {busy:.2f} ms ({100 * busy / wall_ms:.1f}% of wall, idle "
             f"{100 * (1 - busy / wall_ms):.1f}%), {launches:.0f} device ops and "
             f"{host_ops / reps:.0f} aten ops per QC, {h2d:.0f} host-to-device copies per QC"]
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
    for name, durs in top:
        lines.append(f"  {sum(durs) / reps:8.3f} ms  x{len(durs) / reps:6.0f}  {name[:90]}")
    return lines, host_ops / reps, launches


# -- phase 8: the node's certificate path --------------------------------------


def expect_launches(before: dict, verifies: int, what: str) -> None:
    """The kernels launched since ``before`` are those of ``verifies``
    cached-path verifies on warm keys, and nothing else."""
    got = {name: mk.LAUNCHES[name] - before[name] for name in mk.LAUNCHES}
    want = {name: n * verifies for name, n in WARM_QC_LAUNCHES.items()}
    check(got == want, f"{what} launched {got}, expected {want}")


class GatedCuda:
    """A ``CudaBackend`` whose first call waits until ``release`` is set: an
    in-flight device call that later requests pool behind, so a fused
    flush is deterministic. Records each call's size and milliseconds (the
    first call's without its wait)."""

    name = "cuda"

    def __init__(self, inner: CudaBackend) -> None:
        self.inner = inner
        self.calls: list[tuple[int, float]] = []
        self.entered, self.release = threading.Event(), threading.Event()

    def verify_batch(self, msgs, pubs, sigs) -> None:
        if not self.calls:
            self.entered.set()
            if not self.release.wait(300):
                raise SmokeFailure("the gate was never released")
        t = time.perf_counter()
        try:
            self.inner.verify_batch(msgs, pubs, sigs)
        finally:
            self.calls.append((len(msgs), (time.perf_counter() - t) * 1e3))


def pooled(cuda: CudaBackend, opener, calls) -> tuple[list, GatedCuda, BatchingBackend]:
    """Install a fresh ``BatchingBackend(GatedCuda(cuda))``, run ``opener``
    into it, then ``calls`` in threads once its inner call is in flight, and
    open the gate when all of them have pooled. Returns (the exception or
    None of the opener and of each call, the gated backend, the wrapper)."""
    gated = GatedCuda(cuda)
    fusing = BatchingBackend(gated)
    crypto.set_backend(fusing)
    errors = [None] * (len(calls) + 1)

    def run(i, fn):
        try:
            fn()
        except Exception as e:  # the verdict is the exception, read below
            errors[i] = e

    first = threading.Thread(target=run, args=(0, opener))
    first.start()
    check(gated.entered.wait(300), "the opener never reached the device")
    threads = [threading.Thread(target=run, args=(i + 1, fn)) for i, fn in enumerate(calls)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        with fusing._lock:
            if len(fusing._pending) == len(calls):
                break
        time.sleep(0.001)
    gated.release.set()
    for t in (first, *threads):
        t.join(600)
        check(not t.is_alive(), "a pooled request never returned")
    return errors, gated, fusing


def median_ms(fn, reps: int, before=None) -> float:
    out = []
    for _ in range(reps):
        if before is not None:
            before()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return float(np.median(out))


def expect(fn, error: type, what: str) -> None:
    try:
        fn()
    except error:
        return
    raise SmokeFailure(f"{what} was not rejected with {error.__name__}")


def v2_copy(qc: QC, seats: SeatTable) -> QC:
    """A QC as a v2 decode gives it: seats and a packed signature buffer."""
    enc = Encoder()
    qc.encode(enc, seats)
    dec = Decoder(enc.finish())
    out = QC.decode(dec, seats)
    dec.finish()
    return out


def flipped(frame: bytes, pos: int) -> bytes:
    data = bytearray(frame)
    data[pos] ^= 0x01
    return bytes(data)


def node_path(keys, committee, qcs, seed: int):
    """Phase 8: the certificate path as a node runs it, under
    ``set_backend("cuda-batched")``. Returns (launches of the whole phase,
    its numbers, the four-QC fused batch for 8d, the ``BatchingBackend``
    around the ``CudaBackend``)."""
    seats = SeatTable.for_committee(committee)
    secret = dict(keys)
    quorum = committee.quorum_threshold()
    crypto.set_backend("cuda-batched")
    batched = crypto.get_backend()
    check(isinstance(batched, BatchingBackend) and isinstance(batched.inner, CudaBackend),
          f"cuda-batched installed {batched!r}")
    cuda = batched.inner
    numbers = {}
    reset_launches()

    # Committee keys at first sight: one decompression onto the card.
    check(cuda._cache.ensure([pk.data for pk in committee.sorted_keys()]),
          "a committee key failed to decompress")

    # a. A proposal off the wire: a v2 frame, decoded once per process.
    leader = committee.sorted_keys()[4 % len(keys)]
    payload = [crypto.sha512_digest(b"payload", seed.to_bytes(8, "little"), bytes([i]))
               for i in range(4)]
    block = Block.new_from_key(qcs[-1], None, leader, 4, payload, secret[leader])
    frame = encode_propose(block, seats)
    kind, proposal = decode_shared(frame, seats)
    check(kind == "propose" and "_raw_votes" in proposal.qc.__dict__,
          "the proposal's QC is not lazy v2")
    check(encode_propose(proposal, seats) == frame, "re-encoding the proposal changed its bytes")
    check(decode_shared(frame, seats)[1] is proposal, "a second decode_shared decoded again")
    cert_arena.reset()
    before = dict(mk.LAUNCHES)
    proposal.verify(committee, CertificateCache())
    expect_launches(before, 1, "the proposal's verify")
    before = dict(mk.LAUNCHES)
    decode_message(frame, seats)[1].verify(committee, CertificateCache())  # an arena hit
    expect_launches(before, 0, "a proposal whose QC is in the arena")
    numbers["decode_ms"] = median_ms(lambda: decode_message(frame, seats), 20)

    # b. A view change: timeouts carrying v2 high QCs of rounds 1..3 go
    # through the aggregator to a TC, verified off the wire.
    v2_qcs = [v2_copy(q, seats) for q in qcs]
    by_seat = sorted(keys, key=lambda kp: kp[0])
    voters = by_seat[:quorum]
    agg, cache = Aggregator(committee), CertificateCache()
    cert_arena.reset()
    before = dict(mk.LAUNCHES)
    tcs = []
    for i, (pk, sk) in enumerate(voters):
        timeout = Timeout.new_from_key(v2_qcs[i % len(v2_qcs)], TC_ROUND, pk, sk)
        _, arrived = decode_shared(encode_timeout(timeout, seats), seats)
        check("_raw_votes" in arrived.high_qc.__dict__, "a timeout's high QC is not lazy v2")
        arrived.verify(committee, cache)
        tcs.append(agg.add_timeout(arrived))
    check([tc is not None for tc in tcs] == [False] * (quorum - 1) + [True],
          "the TC did not form at the quorum")
    expect_launches(before, len(v2_qcs),
                    f"{len(voters)} timeouts with {len(v2_qcs)} distinct high QCs")
    tc = tcs[-1]
    check(sorted(set(tc.high_qc_rounds())) == [q.round for q in qcs], "the TC's high QC rounds")
    cert_arena.reset()
    late = Timeout.new_from_key(v2_qcs[0], TC_ROUND, *by_seat[quorum])
    before = dict(mk.LAUNCHES)
    late.verify(committee, cache)
    expect_launches(before, 0, "a timeout whose high QC is in the node's cache")
    tc_frame = encode_tc(tc, seats)
    _, tc_v2 = decode_message(tc_frame, seats)
    check("_raw_votes" in tc_v2.__dict__, "the TC is not lazy v2")
    cert_arena.reset()
    before = dict(mk.LAUNCHES)
    tc_v2.verify(committee)
    expect_launches(before, 1, "the TC's verify")
    numbers["tc_ms"] = median_ms(lambda: tc_v2.verify(committee), 5, before=cert_arena.reset)
    records = 1 + 8 + 4 + seats.nbytes  # tag, round, count, bitmap
    bad_tc = decode_message(flipped(tc_frame, records + 72 * (quorum // 2) + 5), seats)[1]
    expect(lambda: bad_tc.verify(committee), errors.InvalidSignature,
           "a TC with a flipped signature byte")
    short = decode_message(encode_tc(TC(tc.round, tc.votes[:-1]), seats), seats)[1]
    expect(lambda: short.verify(committee), errors.TCRequiresQuorum, "a TC one vote below quorum")

    # c. Fusion: the TC opens a flush; four QCs of pipelined rounds pool
    # behind it and fuse into one call.
    four = [*qcs, make_qc(keys, committee, len(qcs) + 1, seed)]
    fused_batch = tuple(sum(parts, []) for parts in zip(*(qc_batch(q) for q in four)))
    fresh_tc = lambda: decode_message(tc_frame, seats)[1].verify(committee)  # noqa: E731
    cert_arena.reset()
    before = dict(mk.LAUNCHES)
    errs, gated, fusing = pooled(cuda, fresh_tc, [lambda q=q: q.verify(committee) for q in four])
    check(errs == [None] * 5, f"fused requests failed: {errs}")
    sizes = [n for n, _ in gated.calls]
    check(sizes == [quorum, 4 * quorum] and fusing.inner_calls == 2, f"fusion made calls {sizes}")
    expect_launches(before, 2, "the TC and the fused flush")
    numbers["fused_first_ms"] = gated.calls[1][1]

    # The same four QCs as a node receives them, off the v2 wire: each is a
    # cert job (``BatchingBackend.verify_cert``) and ``_flush_certs`` makes
    # one inner call per distinct certificate, so they pool but do not fuse.
    four_v2 = [v2_copy(q, seats) for q in four]
    v2_ms = []
    for _ in range(3):
        cert_arena.reset()
        before = dict(mk.LAUNCHES)
        errs, gated, fusing = pooled(cuda, fresh_tc,
                                     [lambda q=q: q.verify(committee) for q in four_v2])
        sizes = [n for n, _ in gated.calls]
        check(errs == [None] * 5 and sizes == [quorum] * 5 and fusing.inner_calls == 5
              and fusing.cert_requests == 5,
              f"four pooled v2 QCs gave calls {sizes}, errors {errs}")
        expect_launches(before, 5, "the TC and four pooled v2 QCs")
        v2_ms.append(sum(ms for _, ms in gated.calls[1:]))
    numbers["v2_pooled_ms"] = float(np.median(v2_ms))

    cert_arena.reset()
    bad = 1  # the tampered one of the four
    mixed = four[:bad] + [tampered(four[bad])] + four[bad + 1:]
    errs, gated, _ = pooled(cuda, fresh_tc, [lambda q=q: q.verify(committee) for q in mixed])
    check(all(e is None for i, e in enumerate(errs) if i != 1 + bad)
          and isinstance(errs[1 + bad], errors.InvalidSignature), f"isolation gave {errs}")
    sizes = [n for n, _ in gated.calls]
    check(sizes == [quorum, 4 * quorum] + [quorum] * 4, f"isolation made calls {sizes}")

    cert_arena.reset()
    copies = [QC(qcs[0].hash, qcs[0].round, list(qcs[0].votes)) for _ in range(8)]
    errs, gated, fusing = pooled(cuda, fresh_tc, [lambda q=q: q.verify(committee) for q in copies])
    sizes = [n for n, _ in gated.calls]
    check(errs == [None] * 9 and sizes == [quorum, quorum] and fusing.deduped_sigs == 7 * quorum,
          f"eight copies gave calls {sizes}, {fusing.deduped_sigs} deduped, errors {errs}")
    phase_launches = launch_counts()

    # e. Numbers. A lone QC through the wrapper against the direct backend
    # (the flusher's handoff), in turns; the fused flush against its four
    # QCs one by one; the serial and the RLC CPU backends on the same QC.
    lone = {"batched": [], "direct": []}
    for _ in range(5):
        for name, backend in (("direct", cuda), ("batched", batched)):
            crypto.set_backend(backend)
            lone[name].append(median_ms(lambda: qcs[0].verify(committee), 1, before=cert_arena.reset))
    numbers["lone_batched_ms"] = float(np.median(lone["batched"]))
    numbers["lone_direct_ms"] = float(np.median(lone["direct"]))
    numbers["fused_ms"] = median_ms(lambda: cuda.verify_batch(*fused_batch), 5)
    crypto.set_backend(cuda)
    numbers["four_alone_ms"] = median_ms(lambda: [q.verify(committee) for q in four], 3,
                                         before=cert_arena.reset)
    for key, cpu in (("cpu_qc_ms", crypto.CpuBackend(use_rlc=False)),
                     ("cpu_rlc_qc_ms", crypto.CpuBackend())):
        crypto.set_backend(cpu)
        numbers[key] = median_ms(lambda: qcs[0].verify(committee), 3, before=cert_arena.reset)
    check(cpu.engine == "native-rlc", f"CpuBackend's engine is {cpu.engine!r}, not native-rlc")
    crypto.set_backend(batched)
    numbers["fused_sigs"] = len(fused_batch[0])
    return phase_launches, numbers, fused_batch, batched


# -- phase 9: the consensus engine on the card ----------------------------------


def native_stats() -> dict:
    """The native transport's counters (``NativeTransport.stats``), or {}
    where no native transport is live in this process."""
    transport = native_net.NativeTransport.get_if_live()
    return transport.stats() if transport is not None else {}


def check_committee_launches(run: dict, what: str) -> None:
    """Every inner call of a card committee's timed rounds launched a warm
    cached QC's kernels (decompress 1, K2 2, K3 2, verdict 1; more
    decompressions are committee keys entering the card's cache), K4 and
    the root alone never, and ``CudaBackend`` made each call."""
    launches, calls = run["launches"], run["inner_calls"]
    check(calls > 0 and run["dispatches"] == calls,
          f"{what}: {run['dispatches']} CudaBackend calls against {calls} inner calls")
    check(launches["verdict"] == calls and launches["msm_partials_signed"] == 2 * calls
          and launches["msm_combine"] == 2 * calls and launches["decompress"] >= calls,
          f"{what}: {calls} inner calls launched {launches}")
    check(launches["msm_partials"] == 0 and launches["sqrt_pow"] == 0,
          f"{what}: K4 or the root alone launched: {launches}")


def gate_inner(backend: BatchingBackend) -> threading.Lock:
    """Wraps the card backend's ``verify_batch`` in a lock, so that the
    counts read at a run's edges under it are not straddled by an inner
    call (the batching backend's flusher thread makes every call)."""
    gate = threading.Lock()
    real = backend.inner.verify_batch

    def gated(*args):
        with gate:
            return real(*args)

    backend.inner.verify_batch = gated
    return gate


async def committee(n: int, seed: int, base_port: int, rounds: int, traced: int = 0,
                    profile: bool = False) -> dict:
    """An in-process committee of ``n`` port engines under the active
    backend, as ``benchmark/committee_scale.py --mode protocol`` of the
    reference runs one. Waits for the first commit on every engine, times
    ``rounds`` more (every engine must commit the same digest each round,
    no timeout may fire, no verification may fail unjudged), then traces
    ``traced`` rounds with the profiler. With telemetry on, the registry's
    counter deltas and histogram sums over the timed rounds go in
    ``out["telemetry"]``; with ``profile``, the engines count their stages
    (``consensus.stage.<kind>.{ns,calls}``) and a sampling profiler with
    stage tags runs over the timed rounds. On the native transport, the C++
    engine's counter deltas over the timed rounds go in ``out["native"]``;
    ``out["fds"]`` is the process's open descriptors at the window's end,
    when every connection of the run is open. Tears every engine down."""
    rng = random.Random(seed)
    keys = [crypto.generate_keypair(seed=rng.randbytes(32))[:2] for _ in range(n)]
    members = Committee({pk: Authority(1, ("127.0.0.1", base_port + i))
                         for i, (pk, _) in enumerate(keys)})
    params = Parameters(timeout_delay=COMMITTEE_TIMEOUT_MS, batch_vote_verification=True)
    backend = crypto.get_backend()
    engines, commits, sinks = [], [], []
    out = {"n": n, "quorum": members.quorum_threshold()}

    async def next_round(limit_s: float, what: str):
        try:
            got = await asyncio.wait_for(asyncio.gather(*[q.get() for q in commits]), limit_s)
        except asyncio.TimeoutError:
            raise SmokeFailure(f"{what}: not every engine committed within {limit_s:.0f} s") from None
        check(len({b.digest() for b in got}) == 1 and len({b.round for b in got}) == 1,
              f"{what}: the engines committed different blocks")
        return got[0]

    def counters():
        timeouts = sum(e.core.timeouts_fired for e in engines)
        failures = sum(e.core.backend_failures for e in engines)
        inner = getattr(backend, "inner", None)
        return dict(timeouts=timeouts, failures=failures,
                    inner_calls=getattr(backend, "inner_calls", 0),
                    requests=getattr(backend, "fused_requests", 0),
                    cert_requests=getattr(backend, "cert_requests", 0),
                    dispatches=getattr(inner, "dispatches", 0), sigs=getattr(inner, "sigs", 0))

    # The timed rounds' counts are read between inner calls: the window's
    # edges take this gate, which every inner call holds, so no call is
    # counted on one side of an edge and launches on the other.
    inner = getattr(backend, "inner", None)
    gate = gate_inner(backend) if inner is not None else threading.Lock()

    # Spawned in descending leader order: the leader of round 1 proposes as
    # soon as it starts, and the votes for its block, sent best effort to
    # the leader of round 2, then find that leader listening (the
    # proposal's reliable sender retries the one engine spawned after it).
    # In another order a vote sent before its receiver listens can be lost,
    # and round 2 waits out the 30 s timeout (seed 1 does so at N = 100).
    secret = dict(keys)
    sampler = None
    try:
        t = time.perf_counter()
        for pk in reversed(members.sorted_keys()):
            sk = secret[pk]
            rx_mempool, tx_mempool, tx_commit = asyncio.Queue(), asyncio.Queue(), asyncio.Queue()

            async def drain(q=tx_mempool):
                while True:
                    await q.get()

            sinks.append(asyncio.create_task(drain()))
            engines.append(await Consensus.spawn(
                pk, members, params, crypto.SignatureService(sk), Store(),
                rx_mempool, tx_mempool, tx_commit, profile=profile,
            ))
            commits.append(tx_commit)
        first = await next_round(COMMITTEE_BOOT_S, "the first commit")
        out["boot_s"] = time.perf_counter() - t
        out["first_round"] = first.round

        if profile:
            sampler = pyprof.SamplingProfiler(interval_ms=pyprof.DEFAULT_INTERVAL_MS)
            sampler.start(mode="auto")
        registry = telemetry.get_registry() if telemetry.enabled() else None
        with gate:
            before = counters()
            tm_before = registry.snapshot() if registry is not None else None
            native_before = native_stats()
            reset_launches()
        t = time.perf_counter()
        committed = [await next_round(COMMITTEE_ROUND_S, f"round {i + 1} of {rounds}")
                     for i in range(rounds)]
        out["ms_per_round"] = (time.perf_counter() - t) * 1e3 / rounds
        with gate:
            out["launches"] = launch_counts()
            tm_after = registry.snapshot() if registry is not None else None
            after = counters()
            native_after = native_stats()
        out["fds"] = len(os.listdir("/proc/self/fd"))
        if native_after:
            out["native"] = {k: v - native_before.get(k, 0) for k, v in native_after.items()}
        if sampler is not None:
            sampler.stop()
            out["stage_samples"] = sampler.stage_totals()
            out["profile_record"] = sampler.drain_record(node="committee")
            out["profile_mode"] = sampler.mode
        if registry is not None:
            hist = {}
            for name, h in tm_after["histograms"].items():
                h0 = tm_before["histograms"].get(name, {"sum": 0.0, "count": 0})
                hist[name] = (h["sum"] - h0["sum"], h["count"] - h0["count"])
            out["telemetry"] = {"counters": telemetry.diff_counters(
                tm_before["counters"], tm_after["counters"]), "histograms": hist}
        out.update({key: after[key] - before[key] for key in after})
        out["rounds"] = [b.round for b in committed]
        check(out["timeouts"] == 0, f"{out['timeouts']} timeouts fired in the measured rounds")
        check(out["failures"] == 0, f"{out['failures']} verifications met BackendUnavailable")
        # A round that timed out while the engines booted has no block, so
        # the committed rounds rise but may skip one.
        check(all(a < b for a, b in zip([first.round] + out["rounds"], out["rounds"])),
              f"the measured commits are of rounds {out['rounds']}")

        if traced:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                for i in range(traced):
                    await next_round(COMMITTEE_ROUND_S, f"traced round {i + 1}")
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3
            durations = device_times(prof)[0].values()
            busy, ops = sum(map(sum, durations)), sum(map(len, durations))
            check(busy > 0, "the profiler saw no device time in the committee's rounds")
            out.update(traced_wall_ms=wall / traced, traced_busy_ms=busy / traced,
                       traced_device_ops=ops / traced)
        check(sum(e.core.backend_failures for e in engines) == 0,
              "a verification met BackendUnavailable")
    finally:
        if sampler is not None:
            sampler.stop()
        for e in engines:
            await e.shutdown()
        for task in sinks:
            task.cancel()
        if inner is not None:
            del inner.verify_batch  # the class's method again
    return out


def committee_phase(seed: int, card: str, device, imad_per_s: float):
    """Phase 9. Returns (launches in the measured rounds, the kernel rows at
    the committee's width, launches in the profiled run's rounds)."""
    cert_arena.reset()
    crypto.set_backend("cuda-batched")
    batched = crypto.get_backend()
    check(isinstance(batched, BatchingBackend) and isinstance(batched.inner, CudaBackend),
          f"cuda-batched installed {batched!r}")
    print(f"committee: RLIMIT_NOFILE soft {FD_LIMITS[0]} raised to {FD_LIMITS[1]} (hard "
          f"{FD_LIMITS[2]}); connection budget cap {BUDGET.cap}")
    t = time.perf_counter()
    gpu = asyncio.run(committee(COMMITTEE_N, seed, COMMITTEE_PORTS[0], COMMITTEE_ROUNDS,
                                traced=COMMITTEE_TRACED_ROUNDS))
    gpu_s = time.perf_counter() - t
    launches, r, calls = gpu["launches"], COMMITTEE_ROUNDS, gpu["inner_calls"]
    check_committee_launches(gpu, "the committee")
    print(f"committee on {card}: N={gpu['n']} (quorum {gpu['quorum']}) under cuda-batched, "
          f"first commit (round {gpu['first_round']}) after {gpu['boot_s']:.2f} s, then {r} rounds "
          f"{gpu['rounds'][0]}-{gpu['rounds'][-1]}, every engine committing the same digest, no "
          f"timeout: {gpu['ms_per_round']:.2f} ms per committed round, "
          f"{1e3 / gpu['ms_per_round']:.3f} rounds/s; phase {gpu_s:.1f} s")
    print(f"committee on {card}: per round {gpu['inner_calls'] / r:.2f} BatchingBackend inner calls "
          f"(= CudaBackend verifications), {gpu['requests'] / r:.2f} requests "
          f"({gpu['cert_requests'] / r:.2f} of them v2 cert jobs), {gpu['sigs'] / r:.1f} signatures; "
          "launches per round " + ", ".join(f"{k} {v / r:.2f}" for k, v in sorted(launches.items()))
          + f" (each inner call: decompress 1, K2 2, K3 2, verdict 1; "
          f"{launches['decompress'] - calls} decompressions filled the key cache)")
    print(f"committee on {card}: {COMMITTEE_TRACED_ROUNDS} traced rounds (profiler on): wall "
          f"{gpu['traced_wall_ms']:.2f} ms per round, device busy {gpu['traced_busy_ms']:.3f} ms "
          f"per round ({100 * gpu['traced_busy_ms'] / gpu['traced_wall_ms']:.2f}% busy, idle "
          f"{100 * (1 - gpu['traced_busy_ms'] / gpu['traced_wall_ms']):.2f}%), "
          f"{gpu['traced_device_ops']:.0f} device ops per round")

    # The yardsticks: the same committee shape under the serial CPU backend,
    # then under the default one (the native RLC engine).
    for label, use_rlc, port, engine in (
            ("CpuBackend(use_rlc=False)", False, COMMITTEE_PORTS[1], "serial"),
            ("CpuBackend()", True, COMMITTEE_PORTS[2], "native-rlc")):
        backend = crypto.CpuBackend(use_rlc=use_rlc)
        check(backend.engine == engine, f"{label}'s engine is {backend.engine!r}, not {engine}")
        crypto.set_backend(backend)
        cert_arena.reset()
        t = time.perf_counter()
        cpu = asyncio.run(committee(COMMITTEE_N, seed + 1, port, COMMITTEE_ROUNDS))
        print(f"committee on the card's host, {label}, engine {engine} (signer: "
              f"{'OpenSSL' if crypto._HAVE_PYCA else 'pure-Python RFC 8032'}): first commit after "
              f"{cpu['boot_s']:.2f} s, {r} rounds {cpu['ms_per_round']:.2f} ms per committed round, "
              f"{1e3 / cpu['ms_per_round']:.3f} rounds/s; phase {time.perf_counter() - t:.1f} s")
    crypto.set_backend(batched)

    profiled = profiled_committee(seed, card, gpu, batched)

    # The cached kernels at the committee's width: one N = 100 QC.
    keys, members = make_committee(COMMITTEE_N, seed)
    qc = make_qc(keys, members, 1, seed)
    check(batched.inner._cache.ensure([pk.data for pk in members.sorted_keys()]),
          "a committee key failed to decompress")
    rows, notes, shapes = kernel_checks(qc_batch(qc), batched.inner, device, imad_per_s,
                                        uncached=False)
    check(shapes[:2] == (128, 128), f"an N = 100 QC ran at mf, mc = {shapes[:2]}")
    print(f"kernels vs plain on the card at the committee's width (limb-exact), "
          f"{len(qc.votes)} signatures, mf={shapes[0]} mc={shapes[1]}:")
    for line in notes:
        print("  " + line)
    return launches, rows, profiled, gpu["ms_per_round"]


def profiled_committee(seed: int, card: str, gpu: dict, batched: BatchingBackend) -> dict:
    """Phase 9's fourth run: the card committee of the first (the same keys)
    with telemetry on, the Core's per-stage counters and a sampling profiler
    with stage tags, read as the reference's ``benchmark/committee_scale.py``
    reads its ``--profile`` run (counter deltas around the timed rounds).
    Telemetry is off for the other runs, and is turned off and cleared after
    this one. Returns its launches."""
    telemetry.enable()
    # Metric objects are taken when an actor is made: a superbatcher and a
    # cert arena made now record (the card's key cache is kept).
    crypto.set_backend(BatchingBackend(batched.inner, max_sigs=batched.max_sigs))
    cert_arena.reset()
    try:
        t = time.perf_counter()
        run = asyncio.run(committee(COMMITTEE_N, seed, COMMITTEE_PORTS[3], COMMITTEE_ROUNDS,
                                    profile=True))
        phase_s = time.perf_counter() - t
    finally:
        crypto.set_backend(batched)
        telemetry.reset_for_tests()  # clears the registry, the rings and the profiler
        telemetry.disable()
        cert_arena.reset()
    r, launches, tm = COMMITTEE_ROUNDS, run["launches"], run["telemetry"]
    deltas, hist = tm["counters"], tm["histograms"]
    calls = run["inner_calls"]
    check(launches["verdict"] == calls and launches["msm_partials_signed"] == 2 * calls
          and launches["msm_combine"] == 2 * calls and launches["msm_partials"] == 0,
          f"the profiled committee's {calls} inner calls launched {launches}")
    dispatched = deltas.get("crypto.dispatch.cuda", 0)
    check(dispatched == launches["verdict"] == calls == run["dispatches"],
          f"crypto.dispatch.cuda moved by {dispatched}: verdict launches {launches['verdict']}, "
          f"inner calls {calls}, CudaBackend calls {run['dispatches']}")
    check(deltas.get("crypto.dispatch.cuda_sigs", 0) == run["sigs"],
          f"crypto.dispatch.cuda_sigs moved by {deltas.get('crypto.dispatch.cuda_sigs', 0)}, "
          f"{run['sigs']} signatures dispatched")
    advanced = deltas.get("consensus.rounds_advanced", 0)
    check(advanced >= r, f"consensus.rounds_advanced moved by {advanced} in {r} rounds")
    stages = {}
    for name, value in deltas.items():
        if name.startswith("consensus.stage."):
            kind, field = name[len("consensus.stage."):].rsplit(".", 1)
            stages.setdefault(kind, {"ns": 0, "calls": 0})[field] += value
    check(stages, "the profiled committee counted no stage")
    for kind, v in stages.items():
        check(v["calls"] > 0, f"stage {kind} took {v['ns']} ns in no call")
    record = run["profile_record"]
    check(record is not None, "the sampling profiler drained no record")
    problems = pyprof.validate_profile_record(record)
    check(not problems, f"the profiler's record is malformed: {problems}")

    wall_ns = run["ms_per_round"] * 1e6 * r
    print(f"committee on {card}, profiled (telemetry on, Core profile=True, sampling profiler "
          f"{run['profile_mode']} mode at {pyprof.DEFAULT_INTERVAL_MS} ms): "
          f"{run['ms_per_round']:.2f} ms per committed round against {gpu['ms_per_round']:.2f} "
          f"unprofiled; {calls / r:.2f} inner calls and {run['sigs'] / r:.1f} signatures a round; "
          f"consensus.rounds_advanced +{advanced} ({advanced / COMMITTEE_N:.2f} an engine); "
          f"crypto.dispatch.cuda +{dispatched} = verdict launches = inner calls; "
          f"crypto.dispatch.cuda_sigs +{deltas['crypto.dispatch.cuda_sigs']}; phase {phase_s:.1f} s")
    for kind, v in sorted(stages.items(), key=lambda kv: -kv[1]["ns"]):
        print(f"committee on {card}, profiled: consensus.stage.{kind}: {v['ns'] / 1e6 / r:.2f} ms "
              f"and {v['calls'] / r:.1f} calls a round ({v['ns'] / v['calls'] / 1e3:.1f} us a call)")
    total_ns = sum(v["ns"] for v in stages.values())
    print(f"committee on {card}, profiled: the stages sum to {total_ns / 1e6 / r:.2f} ms a round, "
          f"{100 * total_ns / wall_ns:.1f}% of the round's wall time ({COMMITTEE_N} engines on one "
          f"event loop; a handler's span includes its awaits, during which other engines' "
          f"handlers run, so spans can overlap)")
    samples = run["stage_samples"]
    n_samples = sum(samples.values())
    n_tagged = n_samples - samples.get("", 0)
    check(n_tagged > 0, "the sampling profiler took no tagged sample")
    tags = list(STAGE_TAGS) + sorted(set(samples) - set(STAGE_TAGS) - {""})
    # Each tick samples every thread. The event loop's thread carries a tag
    # from its first event on; a crypto worker carries "verify" while it
    # verifies; the other threads (idle workers, the flusher) none.
    print(f"committee on {card}, profiled: {record['samples']} ticks of {n_samples} thread "
          f"samples ({record['threads']} threads at the last; ticks {record['gil_delay_ns'] / 1e6:.1f} "
          f"ms late in all), {samples.get('', 0)} untagged; share of the {n_tagged} tagged by stage "
          "tag: " + ", ".join(f"{tag} {100 * samples.get(tag, 0) / n_tagged:.1f}%" for tag in tags))
    self_counts, _ = pyprof.aggregate_self_cum([e for e in record["stacks"] if e[0]])
    print(f"committee on {card}, profiled: the tagged samples' leaf functions: " + ", ".join(
        f"{name} {100 * c / n_tagged:.1f}%" for name, c in self_counts.most_common(8)))
    for name in ("crypto.superbatch.flush_ms", "crypto.superbatch.per_sig_ms"):
        total, count = hist.get(name, (0.0, 0))
        check(count > 0, f"{name} observed nothing in the timed rounds")
        print(f"committee on {card}, profiled: {name} mean {total / count:.4f} over {count} flushes")
    return launches


# -- phase 10: the mempool and the node ------------------------------------------


def sha512_bound(lengths, imad_per_s: float) -> tuple[float, str]:
    """The least time of a drain: its int32 instructions (the model's count
    a 128-byte block, every lane's padded blocks) over the int32 rate, or
    its bytes (messages, offsets and lengths in, digests out) over HBM."""
    blocks = sum(sha.blocks_of(n) for n in lengths)
    t_ops = blocks * SHA512_INT_OPS_PER_BLOCK / imad_per_s
    t_bytes = (sum(lengths) + 16 * len(lengths) + 64 * len(lengths)) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


@functools.lru_cache(maxsize=1)
def sass_counts() -> str:
    """Instructions of ``sha512_kernel`` in the built library's SASS, in
    all and by the int32 opcodes the model counts (``cuobjdump``). Static
    counts: the chain's 8-round loop and the schedule's 16-step loop are
    counted once, not once a block."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return "cuobjdump not found"
    lib = kernel_build.load_all()["sha512"]._name
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=120).stdout
    counts, inside = {}, False
    for line in out.splitlines():
        if "Function :" in line:
            inside = "sha512_kernel" in line
        elif inside and line.strip().startswith("/*") and "*/" in line:
            words = line.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if words:
                op = words[0].split(".")[0]
                counts[op] = counts.get(op, 0) + 1
    total = sum(counts.values())
    return (f"{total} static instructions, SHF {counts.get('SHF', 0)}, LOP3 "
            f"{counts.get('LOP3', 0)}, IADD3 {counts.get('IADD3', 0)}, PRMT {counts.get('PRMT', 0)}, "
            f"LDS {counts.get('LDS', 0)}, STS {counts.get('STS', 0)}, BAR {counts.get('BAR', 0)} "
            f"(the bound's model: {SHA512_INT_OPS_PER_BLOCK} a block)")


def digest_drain(lanes: int, size: int, rng: random.Random) -> list[bytes]:
    return [rng.randbytes(size) for _ in range(lanes)]


def batch_drain(rng: random.Random) -> list[bytes]:
    """128 mempool batches of 12-30 transactions of 512 B (6-15 kB each)."""
    return [encode_batch([b"\x01" + rng.randbytes(511) for _ in range(rng.randint(12, 30))])
            for _ in range(128)]


def sha512_against_plain(msgs, device, what: str) -> tuple[int, float]:
    """The kernel against its plain version on the card, byte for byte, and
    both against hashlib. Returns (max abs err, plain ms)."""
    buf = sha.pack(msgs).to(device)
    got = sha.sha512(*sha.unpack(buf, len(msgs)))
    torch.cuda.synchronize()
    t = time.perf_counter()
    plain = sha.sha512_plain(*sha.unpack(buf, len(msgs)))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    err = max_abs_err(got, plain)
    check(err == 0, f"sha512 ({what}) differs from its plain version by {err}")
    want = [hashlib.sha512(m).digest() for m in msgs]
    check([bytes(r) for r in got.cpu().numpy()] == want, f"sha512 ({what}) differs from hashlib")
    return err, plain_ms


def sha512_parts(msgs, device, reps: int) -> dict:
    """The host clock's split of one ``sha512_32_batch`` call into
    ``ops.sha512.STEPS``, timed inside the call itself (``digests`` with a
    ``mark`` that synchronizes the stream at each step's end; median ms of
    ``reps``): the pack into the staging buffer (its growth included), the
    H2D copy, the launch and the kernel, the D2H copy into the pinned
    buffer, the split into ``bytes``."""
    parts = {k: [] for k in sha.STEPS}
    want = [hashlib.sha512(m).digest()[:32] for m in msgs]
    for _ in range(reps):
        clock = [0.0]

        def mark(step):
            torch.cuda.synchronize()
            now = time.perf_counter()
            if step is not None:
                parts[step].append((now - clock[0]) * 1e3)
            clock[0] = now

        mark(None)
        got = sha.digests(msgs, device, 32, mark)
        check(got == want, "the split sha512_32_batch differs from hashlib")
    return {k: float(np.median(v)) for k, v in parts.items()}


def sha512_chain_floors_ms(lengths, clock_hz: float) -> tuple[float, float]:
    """(chain floor, issue floor) at ``clock_hz``: the longest lane's blocks
    x 80 rounds x the e-chain's dependent instructions x their latency, and
    the same blocks x 80 x the chain warp's int32 instructions a round x the
    cycles each holds its scheduler's pipe."""
    rounds = max(sha.blocks_of(n) for n in lengths) * 80
    return (rounds * SHA512_CHAIN_DEPENDENT_OPS * INT32_DEPENDENT_CYCLES / clock_hz * 1e3,
            rounds * SHA512_CHAIN_ALU_OPS * INT32_WARP_CYCLES / clock_hz * 1e3)


def sha512_times(msgs, device, imad_per_s: float, iters: int) -> dict:
    """Kernel time (events and profiler), the H2D copy apart, the whole
    ``sha512_32_batch`` and its host parts, and ``hashlib`` on the same
    drain, with the bound and the chain floor."""
    pinned = sha.pack(msgs, pin=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    copies = []
    for _ in range(5):
        start.record()
        buf = pinned.to(device, non_blocking=True)
        end.record()
        torch.cuda.synchronize()
        copies.append(start.elapsed_time(end))
    views = sha.unpack(buf, len(msgs))
    ms, ev, pr = kernel_ms(lambda: sha.sha512(*views), iters, PROFILER_NAMES["sha512"])
    want = [hashlib.sha512(m).digest()[:32] for m in msgs]
    e2e, host = [], []
    for _ in range(3 if iters < 20 else 7):
        t = time.perf_counter()
        got = sha.sha512_32_batch(msgs)
        e2e.append((time.perf_counter() - t) * 1e3)
        check(got == want, "sha512_32_batch differs from hashlib")
        t = time.perf_counter()
        [hashlib.sha512(m).digest()[:32] for m in msgs]
        host.append((time.perf_counter() - t) * 1e3)
    parts = sha512_parts(msgs, device, reps=3 if iters < 20 else 7)
    b, by = sha512_bound([len(m) for m in msgs], imad_per_s)
    clock_hz = imad_per_s / (torch.cuda.get_device_properties(0).multi_processor_count
                             * INT32_LANES_PER_SM)
    return dict(ms=ms, events_ms=ev, profiler_ms=pr, h2d_ms=float(np.median(copies)),
                e2e_ms=float(np.median(e2e)), hashlib_ms=float(np.median(host)), bound_ms=b,
                bound_by=by, nbytes=sum(map(len, msgs)), parts=parts,
                **dict(zip(("chain_floor_ms", "issue_floor_ms"),
                           sha512_chain_floors_ms([len(m) for m in msgs], clock_hz))))


def sha512_row(what: str, t: dict, sass: str) -> str:
    p = t["parts"]
    return (f"sha512 drain {what} ({t['nbytes'] / 1e6:.3f} MB) = hashlib: kernel {t['ms']:.4f} ms "
            f"(events {t['events_ms']:.4f}, profiler {t['profiler_ms']:.4f}; bound "
            f"{t['bound_ms']:.6f} ms by {t['bound_by']}; modelled, not measured: chain floor "
            f"{t['chain_floor_ms']:.4f} ms at an assumed {INT32_DEPENDENT_CYCLES} cycles a "
            f"dependent instruction, issue floor {t['issue_floor_ms']:.4f} ms at a hand-counted "
            f"{SHA512_CHAIN_ALU_OPS} instructions a round), "
            f"H2D copy {t['h2d_ms']:.4f} ms, sha512_32_batch {t['e2e_ms']:.3f} ms = pack "
            f"{p['pack']:.3f} + H2D {p['h2d']:.3f} + launch and kernel {p['kernel']:.3f} + D2H "
            f"{p['d2h']:.3f} + bytes {p['bytes']:.3f} ms (host clock, synchronized), hashlib "
            f"{t['hashlib_ms']:.3f} ms; {sass}")


def digest_checks(seed: int, device, imad_per_s: float) -> list[str]:
    """10a and 10b: the kernel against its plain version and hashlib, and
    its times, on the reference digest bench's grid and the node path's
    shapes."""
    rng = random.Random(seed * 7919 + 10)
    notes = []
    lanes = [(f"{n} lanes of 0-1100 B", [rng.randbytes(rng.randrange(0, 1101)) for _ in range(n)])
             for n in SHA_LANE_COUNTS]
    ragged = [b"", rng.randbytes(40_000), b"", rng.randbytes(1)] + [
        rng.randbytes(rng.randrange(0, 300)) for _ in range(28)]
    for what, msgs in (
        ("lengths " + ", ".join(map(str, SHA_LENGTHS)), [rng.randbytes(n) for n in SHA_LENGTHS]),
        ("128 lanes of 0-1024 B", [rng.randbytes(rng.randrange(0, 1025)) for _ in range(128)]),
        ("1024 lanes of 96 B (R || A || M)", digest_drain(1024, 96, rng)),
        *lanes,
        ("ragged CTA: 0 B, 40 kB, 0 B, 1 B and 28 lanes of 0-300 B", ragged),
    ):
        err, plain_ms = sha512_against_plain(msgs, device, what)
        notes.append(f"sha512 {what}: kernel = plain version = hashlib, byte for byte "
                     f"(plain {plain_ms:.1f} ms)")
    ragged = [b"", rng.randbytes(500_000), b""] + [rng.randbytes(rng.randrange(0, 200))
                                                   for _ in range(29)]
    check(sha.sha512_batch(ragged) == [hashlib.sha512(m).digest() for m in ragged],
          "sha512 (ragged CTA, 0 B beside 500 kB) != hashlib")
    notes.append("sha512 ragged CTA: 0 B, 500 kB, 0 B and 29 lanes of 0-200 B = hashlib")
    grid = [(f"{lanes} x {size} B", digest_drain(lanes, size, rng))
            for lanes in DIGEST_DRAINS for size in DIGEST_SIZES]
    grid.append(("128 mempool batches of 12-30 x 512-B txs", batch_drain(rng)))
    grid += [(f"{lanes} x {size} B", digest_drain(lanes, size, rng))
             for lanes, size in SHA_NODE_ROWS]
    regs, stack, spill = ptxas_usage()["sha512"]
    sass = f"{regs} registers, {stack} B stack, {spill} B spill stores; SASS {sass_counts()}"
    for what, msgs in grid:
        got = sha.sha512_batch(msgs)
        check(got == [hashlib.sha512(m).digest() for m in msgs], f"sha512 ({what}) != hashlib")
        big = sum(map(len, msgs)) > 16_000_000
        notes.append(sha512_row(what, sha512_times(msgs, device, imad_per_s, iters=5 if big else 20),
                                sass))
    return notes


class NodeRun(logging.Handler):
    """What phases 10c and 11 share of an in-process committee: the nodes,
    booted from the committee and parameters files in ``tmp``, each block
    they commit with its time, the records of the named loggers, each with
    the node whose task emitted it (every task of node i, and of client i,
    which sends to node i, runs in a context where ``node_of`` is i; see
    ``spawn``), and the garbage collector's pauses while watched (each stops
    every thread that wants the interpreter, the nodes' one event loop
    among them)."""

    def __init__(self, loggers, tmp: str, keep_batches: bool = False) -> None:
        super().__init__()
        self.tmp = tmp
        # Committed batches as node i read them at commit (phase 12b: a
        # compaction later drops those below its floor from the stores).
        self.batches: dict | None = {} if keep_batches else None
        self.node_of: contextvars.ContextVar[int] = contextvars.ContextVar("node")
        self.records: list[tuple[int, logging.LogRecord]] = []
        self.pauses: list[tuple[int, float]] = []
        self.nodes, self.commits, self.tasks = [], [], []
        self._started: dict[int, float] = {}
        self._levels = {}
        for name in loggers:
            logger = logging.getLogger(name)
            self._levels[name] = logger.level
            logger.addHandler(self)
            logger.setLevel(logging.INFO)
            logger.propagate = False

    def emit(self, record):
        self.records.append((self.node_of.get(-1), record))

    def spawn(self, i: int, coro, name: str | None = None) -> asyncio.Task:
        ctx = contextvars.copy_context()
        ctx.run(self.node_of.set, i)
        return asyncio.create_task(coro, name=name, context=ctx)

    async def boot(self, secrets, device) -> float:
        """One port ``Node`` a secret (benchmark logging on), spawned in
        descending leader order as phase 9 does, and a task a node that
        records its commits. Returns the seconds it took."""
        from hotstuff_tpu_torch.node import Node

        index = {s.name: i for i, s in enumerate(secrets)}
        booted = {}
        t = time.perf_counter()
        for s in sorted(secrets, key=lambda s: s.name, reverse=True):
            i = index[s.name]
            key_file = f"{self.tmp}/node_{i}.json"
            s.write(key_file)
            booted[i] = await self.spawn(i, Node.new(
                f"{self.tmp}/committee.json", key_file, f"{self.tmp}/db_{i}",
                parameters_file=f"{self.tmp}/parameters.json", benchmark=True, device=device))
        self.nodes = [booted[i] for i in range(len(secrets))]
        self.commits = [[] for _ in self.nodes]
        self.tasks = [asyncio.create_task(self._record_commits(i)) for i in range(len(self.nodes))]
        return time.perf_counter() - t

    async def _record_commits(self, i: int) -> None:
        while True:
            block = await self.nodes[i].commit.get()
            self.commits[i].append((time.time(), block))
            if self.batches is not None:
                for d in block.payload:
                    data = await self.nodes[i].store.read(d.data)
                    if data is not None:
                        self.batches.setdefault(d, data)

    def payload_commits(self, i: int) -> list:
        return [(ts, b) for ts, b in self.commits[i] if b.payload]

    async def first_payload_commit(self, deadline_s: float, alive) -> None:
        """Waits for a payload block committed on every node, failing after
        ``deadline_s`` or when ``alive()`` turns false."""
        deadline = time.monotonic() + deadline_s
        while not all(self.payload_commits(i) for i in range(len(self.nodes))):
            check(time.monotonic() < deadline, "no payload block committed on every node")
            alive()
            await asyncio.sleep(0.05)

    def first_commits(self) -> tuple[int, dict]:
        """Checks that every node committed the same sequence of payload
        blocks (the last two may be on their way). Returns its length and
        each committed digest's first commit time on any node."""
        seqs = [[b.digest() for _, b in self.payload_commits(i)] for i in range(len(self.nodes))]
        short = min(map(len, seqs))
        check(all(q[:short] == seqs[0][:short] for q in seqs),
              "the nodes committed different sequences of payload blocks")
        check(max(map(len, seqs)) - short <= 2, f"payload commits per node {list(map(len, seqs))}")
        first = {}
        for i in range(len(self.nodes)):
            for ts, b in self.payload_commits(i):
                for d in b.payload:
                    first[d] = min(ts, first.get(d, ts))
        return short, first

    def rounds_per_s(self, mark: int, t0: float, t1: float) -> float:
        """Node 0's committed rounds from its ``mark``-th commit to ``t1``."""
        rounds = [b.round for ts, b in self.commits[0][mark:] if ts <= t1]
        before = [b.round for _, b in self.commits[0][:mark]]
        return (max(rounds) - max(before)) / (t1 - t0) if rounds else 0.0

    def samples(self, first_commit: dict, txs_of: dict, t0: float, t1: float,
                slack_s: float) -> dict:
        """Sample transactions, as the harness's LogParser pairs them: client
        i's send, node i's batch that holds it, that batch's first commit;
        the committed batch's transactions must hold it. Returns the send-
        to-commit latencies of those sent in [t0, t1], and the samples sent
        ``slack_s`` or more before t1 that never committed."""
        sent, batch_of = {}, {}
        for i, r in self.records:
            if r.msg == "Sending sample transaction %d":
                sent[(i, r.args[0])] = r.created
            elif r.msg == "Batch %s contains sample tx %d":
                batch_of[(i, r.args[1])] = r.args[0]
        found = {}
        for key, d in batch_of.items():
            if d in first_commit:
                sample = b"\x00" + key[1].to_bytes(8, "big")
                check(any(tx[:9] == sample for tx in txs_of[d]),
                      f"batch {d!r} lacks the sample transaction {key[1]} it was logged with")
                found[key] = first_commit[d]
        expected = [key for key, ts in sent.items() if ts <= t1 - slack_s]
        missing = [key for key in expected if key not in found]
        check(expected, "no sample transaction was sent")
        latency = sorted(found[key] - sent[key] for key, ts in sent.items()
                         if t0 <= ts <= t1 and key in found)
        check(latency, "no sample transaction sent in the window committed")
        return {"expected": len(expected), "missing": len(missing),
                "unsealed": sum(key not in batch_of for key in missing),
                "missing_sent_s": (min((sent[k] - t1 for k in missing), default=0.0),
                                   max((sent[k] - t1 for k in missing), default=0.0)),
                "samples": len(latency),
                "p50_ms": 1e3 * float(np.percentile(latency, 50)),
                "p95_ms": 1e3 * float(np.percentile(latency, 95))}

    def _on_gc(self, phase, info):
        me = threading.get_ident()
        if phase == "start":
            self._started[me] = time.perf_counter()
        elif me in self._started:
            self.pauses.append((info["generation"], time.perf_counter() - self._started.pop(me)))

    def watch_gc(self) -> None:
        gc.callbacks.append(self._on_gc)

    def unwatch_gc(self) -> dict:
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)
        return {"gc_pauses": len(self.pauses),
                "gc_full": sum(generation == 2 for generation, _ in self.pauses),
                "gc_longest_ms": 1e3 * max((secs for _, secs in self.pauses), default=0.0)}

    async def stop(self, read=None):
        """Shuts the nodes down and removes their directory; ``read(tmp)``,
        when given, reads it first (the nodes' streams are whole once they
        are shut down). Returns what ``read`` returned."""
        self.unwatch_gc()
        for task in self.tasks:
            task.cancel()
        for node in self.nodes:
            await node.shutdown()
        for name, level in self._levels.items():
            logger = logging.getLogger(name)
            logger.removeHandler(self)
            logger.setLevel(level)
            logger.propagate = True
        try:
            return read(self.tmp) if read is not None else None
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)


class VerifyWidths:
    """Wraps ``inner.verify_batch`` (the batching backend's flusher thread
    calls it) to record the signatures of each call and the first batch
    verified at each (mf, mc), for the kernels' checks against their plain
    versions at the widths a window ran them at. While ``calls`` is a list,
    each call also logs its start, its width, its distinct messages and the
    launches it made: the flusher is the one thread that calls the inner
    backend, so the counts' change across a call is that call's own."""

    def __init__(self, inner: CudaBackend) -> None:
        self.inner, self.real, self.lock = inner, inner.verify_batch, threading.Lock()
        self.widths, self.sig_counts = {}, {}
        self.calls = None
        inner.verify_batch = self._recording

    def _recording(self, msgs, pubs, sigs):
        t, before = time.monotonic(), launch_counts()
        self.real(msgs, pubs, sigs)  # raises on rejection
        after = launch_counts()
        n = len(msgs)
        with self.lock:
            self.sig_counts[n] = self.sig_counts.get(n, 0) + 1
            self.widths.setdefault((ov._pad_to_pow2(n), ov._pad_to_pow2(n + 1)),
                                   (list(msgs), list(pubs), list(sigs)))
            if self.calls is not None:
                self.calls.append((t, n, set(map(bytes, msgs)),
                                   {k: after[k] - before[k] for k in after}))

    def stop(self) -> tuple[dict, dict]:
        del self.inner.verify_batch
        with self.lock:
            return dict(self.widths), dict(sorted(self.sig_counts.items()))


def width_checks(widths: dict, inner: CudaBackend, device, imad_per_s: float, what: str) -> dict:
    """The cached path's kernels against their plain versions at every
    (mf, mc) a window ran them at, each on a batch the path verified at that
    width. Returns the widest width's rows."""
    check(widths, f"the {what} window verified nothing on the card")
    qc_rows = {}
    for (mf, mc), batch in sorted(widths.items()):
        rows, notes, shapes = kernel_checks(batch, inner, device, imad_per_s, uncached=False)
        check(shapes[:2] == (mf, mc), f"a batch of {len(batch[0])} ran at mf, mc = {shapes[:2]}")
        print(f"kernels vs plain on the card at a {what} width (limb-exact), "
              f"{len(batch[0])} signatures, mf={mf} mc={mc}:")
        for line in notes:
            print("  " + line)
        qc_rows = rows
    return qc_rows


def freeze_heap() -> str:
    """Collect, then freeze what the earlier phases left alive out of the
    garbage collector: a full collection traverses every tracked object and
    stops the in-process nodes' event loop while it runs, and node
    processes would not hold that heap. Returns what it did, for the log."""
    t = time.perf_counter()
    gc.collect()
    collect_ms = (time.perf_counter() - t) * 1e3
    gc.freeze()
    frozen = gc.get_freeze_count()
    t = time.perf_counter()
    gc.collect()
    frozen_collect_ms = (time.perf_counter() - t) * 1e3
    return (f"a full collection took {collect_ms:.1f} ms, then {frozen:,} objects were frozen "
            f"out of the collector and a full collection took {frozen_collect_ms:.1f} ms")


async def config1(seed: int, device, base: int = NODE_PORTS) -> dict:
    """Four port nodes at BASELINE config 1 (``fab local``) in this process,
    four port clients at 250 tx/s each; see phase 10c in the docstring.
    ``out["engines"]`` names the engine each node's store opened."""
    from hotstuff_tpu_torch.node import Committee as NodeCommittee
    from hotstuff_tpu_torch.node import Parameters as NodeParameters
    from hotstuff_tpu_torch.node import Secret
    from hotstuff_tpu_torch.node.client import run_client

    rng = random.Random(seed * 7919 + 11)
    secrets = [Secret(*crypto.generate_keypair(seed=rng.randbytes(32))) for _ in range(NODE_N)]
    consensus = Committee({s.name: Authority(1, ("127.0.0.1", base + i))
                           for i, s in enumerate(secrets)})
    mempool = MempoolCommittee({s.name: MempoolAuthority(
        1, ("127.0.0.1", base + 10 + i), ("127.0.0.1", base + 20 + i))
        for i, s in enumerate(secrets)})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nodes_")
    NodeCommittee(consensus, mempool).write(f"{tmp}/committee.json")
    NodeParameters(
        Parameters(timeout_delay=NODE_TIMEOUT_MS),
        MempoolParameters(batch_size=NODE_BATCH_BYTES, max_batch_delay=NODE_BATCH_DELAY_MS,
                          device_batch_digests=True),
    ).write(f"{tmp}/parameters.json")
    # The certificate path's backend as a user picks it: the variable, read
    # at the first ``get_backend()``.
    os.environ["HOTSTUFF_CRYPTO_BACKEND"] = "cuda-batched"
    crypto._BACKEND = None
    # Each node streams its telemetry as under ``benchmark/local.py``: the
    # variable names the directory and the node names its file.
    os.environ["HOTSTUFF_TELEMETRY_DIR"] = f"{tmp}/telemetry"
    telemetry.enable()
    cert_arena.reset()  # after enable: the arena takes its counters when made
    sigterm = signal.getsignal(signal.SIGTERM)  # each node chains a final flush on it

    run = NodeRun(("client", "mempool"), tmp)
    drains: list[list[bytes]] = []
    real_digest = processor._device_digest_many

    def recording(batches, dev):
        drains.append(list(batches))
        return real_digest(batches, dev)

    processor._device_digest_many = recording
    clients = []
    out = {}
    try:
        out["boot_s"] = await run.boot(secrets, device)
        nodes = run.nodes
        out["engines"] = [type(n.store._engine).__name__ for n in nodes]
        backend = crypto.get_backend()
        check(isinstance(backend, BatchingBackend) and isinstance(backend.inner, CudaBackend),
              f"HOTSTUFF_CRYPTO_BACKEND=cuda-batched installed {backend!r}")
        t = time.perf_counter()
        addresses = [("127.0.0.1", base + 10 + i) for i in range(NODE_N)]
        clients = [run.spawn(i, run_client(
            addresses[i], NODE_TX_BYTES, NODE_RATE // NODE_N, NODE_TIMEOUT_MS, addresses,
            duration=600)) for i in range(NODE_N)]

        def alive():
            for n in nodes:
                check(not n.mempool.failed.done(), "a mempool actor died")

        await run.first_payload_commit(NODE_BOOT_S, alive)
        out["first_commit_s"] = out["boot_s"] + time.perf_counter() - t

        # The measured window: counts zeroed just before, read just after.
        run.watch_gc()
        timeouts0 = sum(n.consensus.core.timeouts_fired for n in nodes)
        mark = len(run.commits[0])
        reset_launches()
        processor.reset_stats()
        recorder = VerifyWidths(backend.inner)
        t0 = time.time()
        await asyncio.sleep(NODE_WINDOW_S)
        t1 = time.time()
        out.update(run.unwatch_gc())
        out["widths"], out["sig_counts"] = recorder.stop()
        out["launches"] = launch_counts()
        out["inner"] = backend.inner
        out["stats"] = dict(processor.STATS)
        out["drain_sizes"] = dict(sorted(processor.DRAIN_SIZES.items()))
        out["timeouts"] = sum(n.consensus.core.timeouts_fired for n in nodes) - timeouts0
        for task in clients:
            task.cancel()
        await asyncio.sleep(NODE_DRAIN_S)  # what was sent commits
        for n in nodes:
            if n.mempool.failed.done():
                n.mempool.failed.result()  # raises what killed the actor

        out["payload_blocks"], first_commit = run.first_commits()
        # Every committed digest reads back from all four stores, and is the
        # SHA-512/32 of the stored bytes.
        txs_of = {}
        for d in first_commit:
            stored = [await n.store.read(d.data) for n in nodes]
            check(stored[0] is not None and all(x == stored[0] for x in stored),
                  f"batch {d!r} does not read back equal from every store")
            check(hashlib.sha512(stored[0]).digest()[:32] == d.data,
                  f"batch {d!r}: the stored bytes hash to another digest")
            kind, txs = decode_batch(stored[0])
            check(kind == "batch", f"batch {d!r} is a {kind}")
            txs_of[d] = txs
        out["committed_batches"] = len(first_commit)
        # Throughput: transactions in batches first committed in the window.
        in_window = [d for d, ts in first_commit.items() if t0 <= ts <= t1]
        out["tx_per_s"] = sum(len(txs_of[d]) for d in in_window) / (t1 - t0)
        out["batches_per_s"] = len(in_window) / (t1 - t0)
        out["rounds_per_s"] = run.rounds_per_s(mark, t0, t1)
        out.update(run.samples(first_commit, txs_of, t0, t1, NODE_SAMPLE_SLACK_S))
        lo, hi = out["missing_sent_s"]
        check(out["missing"] == 0,
              f"{out['missing']} of {out['expected']} sample transactions never committed "
              f"({out['unsealed']} never sealed into a batch; sent {lo:.2f} to {hi:.2f} s from "
              f"the window's end)")
        out["drains"] = drains
        out["window_s"] = t1 - t0
    finally:
        for task in clients:
            task.cancel()
        out["streams"] = await run.stop(read=read_streams)
        for n in run.nodes:
            # The final snapshot is written; without a trace ring the atexit
            # flush has nothing to dump into the directory just removed.
            if n.telemetry_emitter is not None:
                n.telemetry_emitter.trace = None
        signal.signal(signal.SIGTERM, sigterm)
        del os.environ["HOTSTUFF_TELEMETRY_DIR"]
        telemetry.reset_for_tests()  # clears the registry, the rings and the profiler
        telemetry.disable()
        cert_arena.reset()
        processor._device_digest_many = real_digest
        del os.environ["HOTSTUFF_CRYPTO_BACKEND"]
    return out


def read_streams(tmp: str) -> dict:
    """Each node's telemetry stream in ``tmp``: the port's validator's report
    (every line checked against its schema) and its last snapshot."""
    out = {}
    if not os.path.isdir(f"{tmp}/telemetry"):
        return out  # the nodes never booted
    for name in sorted(os.listdir(f"{tmp}/telemetry")):
        path = f"{tmp}/telemetry/{name}"
        if not name.startswith("telemetry-"):
            continue
        snapshots = []
        with open(path) as f:
            for line in f:
                record = json.loads(line)
                if record.get("schema") == telemetry.SCHEMA:
                    snapshots.append(record)
        out[name] = (validate_stream(path), snapshots[-1] if snapshots else None)
    return out


def node_phase(seed: int, card: str, device, imad_per_s: float):
    """Phase 10c, the QC kernels at its widths and the digest kernel at its
    drains. Returns (launches in the measured window, the digest kernel's
    JSON row, the QC kernels' rows at the widest width)."""
    # The four nodes share this process with what phases 1-10b left alive.
    frozen = freeze_heap()
    t = time.perf_counter()
    run = asyncio.run(config1(seed, device))
    phase_s = time.perf_counter() - t
    launches, stats = run["launches"], run["stats"]
    check(launches["sha512"] >= 1, f"no drain of more than one batch ran the kernel: {stats}")
    for name in PHASE10_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched on the node path")
    check(launches["msm_partials"] == 0 and launches["sqrt_pow"] == 0,
          f"the node path launched K4 or the root alone: {launches}")
    check(run["timeouts"] == 0, f"{run['timeouts']} timeouts fired in the measured window (the "
          f"garbage collector ran {run['gc_pauses']} times, {run['gc_full']} full, the longest "
          f"{run['gc_longest_ms']:.1f} ms)")
    print(f"config 1 on {card}: {NODE_N} port nodes ({'/'.join(sorted(set(run['engines'])))} "
          f"stores, keys from --seed), "
          f"HOTSTUFF_CRYPTO_BACKEND=cuda-batched, timeout {NODE_TIMEOUT_MS} ms, batch "
          f"{NODE_BATCH_BYTES} B, max batch delay {NODE_BATCH_DELAY_MS} ms, device digests on; "
          f"{NODE_N} clients at {NODE_RATE // NODE_N} tx/s of {NODE_TX_BYTES} B; booted in "
          f"{run['boot_s']:.2f} s, first payload commit on every node at {run['first_commit_s']:.2f} "
          f"s; phase {phase_s:.1f} s; before it {frozen}")
    print(f"config 1 on {card}: over {run['window_s']:.2f} s: {run['tx_per_s']:.1f} committed tx/s "
          f"({run['batches_per_s']:.1f} batches/s), {run['rounds_per_s']:.2f} rounds/s, sample tx "
          f"send-to-commit latency p50 {run['p50_ms']:.1f} ms, p95 {run['p95_ms']:.1f} ms "
          f"({run['samples']} samples); every node committed the same {run['payload_blocks']} "
          f"payload blocks; {run['committed_batches']} committed batches read back from all "
          f"{NODE_N} stores and equal hashlib's SHA-512/32; no timeout; the garbage collector "
          f"ran {run['gc_pauses']} times in the window ({run['gc_full']} full), the longest "
          f"{run['gc_longest_ms']:.1f} ms")
    print(f"config 1 on {card}: drains by size {run['drain_sizes']}; batches hashed on the card "
          f"{stats['device_batches']}, on the host {stats['host_batches']}; launches "
          + ", ".join(f"{k} {v}" for k, v in sorted(launches.items())))
    print(f"config 1 on {card}: CudaBackend calls by signatures {run['sig_counts']}")
    streams = run["streams"]
    check(len(streams) == NODE_N, f"{len(streams)} telemetry streams for {NODE_N} nodes")
    for name, (report, final) in streams.items():
        check(report["ok"] and report["self_described"] and not report["unknown_schema"],
              f"{name} fails the validator: {report['problems'][:3]}")
        check(final is not None and final["final"], f"{name} holds no final snapshot")
        for counter in ("consensus.qcs_formed", "mempool.batches_sealed", "net.frames_in"):
            check(final["counters"].get(counter, 0) > 0, f"{name}: {counter} did not move")
    # The four nodes share this process's registry, so each final snapshot
    # holds the committee's totals: the harness's reader (benchmark/logs.py
    # TelemetryParser) applied to the newest one, from the first proposal to
    # the last commit.
    last = max((final for _, final in streams.values()), key=lambda f: f["ts"])
    span_s = last["gauges"]["consensus.last_commit_ts"] - last["gauges"]["consensus.first_proposal_ts"]
    tele_tps = last["counters"]["consensus.committed_bytes"] / NODE_TX_BYTES / span_s
    latency = last["histograms"]["consensus.commit_latency_ms"]
    counts = {}
    for report, _ in streams.values():
        for schema, n in report["counts"].items():
            counts[schema] = counts.get(schema, 0) + n
    print(f"config 1 on {card}: {len(streams)} telemetry streams (HOTSTUFF_TELEMETRY_DIR) pass the "
          f"validator line by line, {sum(r['lines'] for r, _ in streams.values())} lines: "
          + ", ".join(f"{k} {v}" for k, v in sorted(counts.items()) if v)
          + f"; final snapshot: consensus.qcs_formed {last['counters']['consensus.qcs_formed']}, "
          f"mempool.batches_sealed {last['counters']['mempool.batches_sealed']}, net.frames_in "
          f"{last['counters']['net.frames_in']}")
    print(f"config 1 on {card}: committed tx/s from the final snapshots {tele_tps:.1f} over "
          f"{span_s:.2f} s (first proposal to last commit, boot and drain included; consensus "
          f"latency mean {latency['sum'] / max(latency['count'], 1):.1f} ms over "
          f"{latency['count']} batches) beside {run['tx_per_s']:.1f} from the logs over the "
          f"{run['window_s']:.2f} s window")
    qc_rows = width_checks(run["widths"], run["inner"], device, imad_per_s, "config 1")
    # The kernel at the widest drain the node path gave it, against its plain
    # version on the same inputs.
    msgs = max(run["drains"], key=len)
    err, plain_ms = sha512_against_plain(msgs, device, "the node path's widest drain")
    timed = sha512_times(msgs, device, imad_per_s, iters=20)
    lengths = sorted(map(len, msgs))
    shape = f"drain of {len(msgs)} lanes, {lengths[0]}-{lengths[-1]} B"
    print(f"sha512 at the node path's widest {shape}: kernel = plain version = hashlib "
          f"(plain {plain_ms:.1f} ms); " + sha512_row(shape, timed, "")[len("sha512 drain "):])
    row = dict(max_abs_err=err, ms=timed["ms"], plain_ms=plain_ms, bound_ms=timed["bound_ms"],
               bound_by=timed["bound_by"], shape=shape, hashlib_ms=timed["hashlib_ms"],
               sha512_32_batch_ms=timed["e2e_ms"], host_parts_ms=timed["parts"],
               config1_tx_per_s=run["tx_per_s"], config1_telemetry_tx_per_s=tele_tps,
               config1_p50_ms=run["p50_ms"],
               config1_p95_ms=run["p95_ms"], config1_rounds_per_s=run["rounds_per_s"])
    return launches, row, qc_rows


async def conveyor(seed: int, device, base: int = CONVEYOR_PORTS,
                   scenario: str | None = None) -> dict:
    """Four port nodes with two workers each, and four sharded port clients
    at 5,000 tx/s each, in this process; see phase 11 in the docstring.
    With ``scenario``, the nodes boot under ``HOTSTUFF_FAULTLINE=scenario``
    (phase 15d)."""
    from hotstuff_tpu_torch.mempool import WorkerEntry
    from hotstuff_tpu_torch.mempool.dataplane import AvailabilityCert, WorkerSeatTable
    from hotstuff_tpu_torch.mempool.dataplane import messages as dpm
    from hotstuff_tpu_torch.node import Committee as NodeCommittee
    from hotstuff_tpu_torch.node import Parameters as NodeParameters
    from hotstuff_tpu_torch.node import Secret
    from hotstuff_tpu_torch.node.client import run_sharded_client

    n = CONVEYOR_N
    rng = random.Random(seed * 7919 + 23)
    secrets = [Secret(*crypto.generate_keypair(seed=rng.randbytes(32))) for _ in range(n)]

    def ingress(w: int, i: int) -> tuple[str, int]:
        return ("127.0.0.1", base + (3 + 2 * w) * n + i)

    consensus = Committee({s.name: Authority(1, ("127.0.0.1", base + i))
                           for i, s in enumerate(secrets)})
    mempool = MempoolCommittee({s.name: MempoolAuthority(
        1, ("127.0.0.1", base + n + i), ("127.0.0.1", base + 2 * n + i),
        [WorkerEntry(ingress(w, i), ("127.0.0.1", base + (4 + 2 * w) * n + i))
         for w in range(CONVEYOR_WORKERS)])
        for i, s in enumerate(secrets)})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_conveyor_")
    NodeCommittee(consensus, mempool).write(f"{tmp}/committee.json")
    NodeParameters(
        Parameters(timeout_delay=CONVEYOR_TIMEOUT_MS),
        MempoolParameters(batch_size=CONVEYOR_BATCH_BYTES, max_batch_delay=CONVEYOR_BATCH_DELAY_MS,
                          workers=CONVEYOR_WORKERS),
    ).write(f"{tmp}/parameters.json")
    os.environ["HOTSTUFF_CRYPTO_BACKEND"] = "cuda-batched"
    if scenario is not None:
        os.environ["HOTSTUFF_FAULTLINE"] = scenario
    crypto._BACKEND = None
    cert_arena.reset()

    run = NodeRun(("client", "mempool", "consensus"), tmp)
    clients = []
    out = {}

    def counts() -> dict:
        workers = [w for node in run.nodes for w in node.mempool.dataplane.workers]
        return {
            "sealed": sum(w.batches_sealed for w in workers),
            "certs_formed": sum(w.certs_formed for w in workers),
            "certs_failed": sum(w.certs_failed for w in workers),
            "acks_invalid": sum(w.acks_invalid for w in workers),
            "certs_stored": sum(w.peer_handler.certs_stored for w in workers),
            "certs_rejected": sum(w.peer_handler.certs_rejected for w in workers),
            "shed": sum(w.ingress.shed for w in workers),
            "fetched": sum(node.resolver.batches_fetched for node in run.nodes),
            "unresolved": sum(node.resolver.unresolved for node in run.nodes),
        }

    try:
        out["boot_s"] = await run.boot(secrets, device)
        nodes = run.nodes
        for node in nodes:
            check(node.mempool.dataplane is not None and node.resolver_task is not None
                  and len(node.mempool.dataplane.workers) == CONVEYOR_WORKERS,
                  "a node started without its data plane or its commit resolver")
        backend = crypto.get_backend()
        check(isinstance(backend, BatchingBackend) and isinstance(backend.inner, CudaBackend),
              f"HOTSTUFF_CRYPTO_BACKEND=cuda-batched installed {backend!r}")
        t = time.perf_counter()
        fronts = [("127.0.0.1", base + n + i) for i in range(n)]
        clients = [run.spawn(i, run_sharded_client(
            [ingress(w, i) for w in range(CONVEYOR_WORKERS)], CONVEYOR_TX_BYTES,
            CONVEYOR_RATE // n, CONVEYOR_TIMEOUT_MS, fronts, duration=600)) for i in range(n)]

        def alive():
            check(not any(c.done() for c in clients), "a client ended")

        await run.first_payload_commit(NODE_BOOT_S, alive)
        out["first_commit_s"] = out["boot_s"] + time.perf_counter() - t

        # The measured window: counts zeroed (or read) just before, read
        # just after.
        run.watch_gc()
        timeouts0 = sum(node.consensus.core.timeouts_fired for node in nodes)
        mark = len(run.commits[0])
        before = counts()
        reset_launches()
        recorder = VerifyWidths(backend.inner)
        t0 = time.time()
        await asyncio.sleep(NODE_WINDOW_S)
        t1 = time.time()
        out.update(run.unwatch_gc())
        out["widths"], out["sig_counts"] = recorder.stop()
        out["launches"] = launch_counts()
        after = counts()
        out["inner"] = backend.inner
        out["counts"] = {k: after[k] - before[k] for k in after}
        out["timeouts"] = sum(node.consensus.core.timeouts_fired for node in nodes) - timeouts0
        for task in clients:
            task.cancel()
        await asyncio.sleep(CONVEYOR_DRAIN_S)  # what was sent commits
        out["counts_total"] = counts()

        out["payload_blocks"], first_commit = run.first_commits()
        # Every committed batch reads back from all four stores, parses as a
        # worker batch and hashes to its digest; a certificate of it is in at
        # least three stores, decodes with the seat table and verifies.
        seats = WorkerSeatTable.for_committee(mempool)
        txs_of, certs = {}, 0
        for d in first_commit:
            stored = [await node.store.read(d.data) for node in nodes]
            check(stored[0] is not None and all(x == stored[0] for x in stored),
                  f"batch {d!r} does not read back equal from every store")
            check(hashlib.sha512(stored[0]).digest()[:32] == d.data,
                  f"batch {d!r}: the stored bytes hash to another digest")
            _, n_txs, _, blob = dpm.decode_worker_batch(stored[0])
            txs_of[d] = dpm.split_blob(blob)
            check(len(txs_of[d]) == n_txs, f"batch {d!r} holds {len(txs_of[d])} of {n_txs} txs")
            held = [raw for node in nodes
                    if (raw := await node.store.read(dpm.cert_key(d.data))) is not None]
            check(len(held) >= 3, f"batch {d!r}: a certificate in {len(held)} stores")
            for raw in held:
                cert = AvailabilityCert.decode(raw, seats)
                check(cert.digest == d, f"the certificate under {d!r} is another batch's")
                cert.verify(mempool)  # raises CertError
                certs += 1
        out["committed_batches"], out["certs_verified"] = len(first_commit), certs
        in_window = [d for d, ts in first_commit.items() if t0 <= ts <= t1]
        out["tx_per_s"] = sum(len(txs_of[d]) for d in in_window) / (t1 - t0)
        out["batches_per_s"] = len(in_window) / (t1 - t0)
        out["rounds_per_s"] = run.rounds_per_s(mark, t0, t1)
        # Consensus: a batch from its first proposal to its first commit,
        # for the batches first proposed in the window (LogParser's
        # consensus latency; its throughput over that span); and what the
        # clients logged of the back-pressure.
        created, out["rate_misses"], out["client_sheds"] = {}, 0, 0
        for _, r in run.records:
            if r.msg == "Created %s -> %s":
                created[r.args[1]] = min(r.created, created.get(r.args[1], r.created))
            elif r.msg == "Transaction rate too high for this client" and t0 <= r.created <= t1:
                out["rate_misses"] += 1
            elif r.msg == "Shed notifications: %d":
                out["client_sheds"] = max(out["client_sheds"], r.args[0])
        proposed = [d for d, ts in created.items() if t0 <= ts <= t1 and d in first_commit]
        check(proposed, "no batch proposed in the window committed")
        consensus_lat = sorted(first_commit[d] - created[d] for d in proposed)
        span = max(first_commit[d] for d in proposed) - min(created[d] for d in proposed)
        out["consensus_tx_per_s"] = sum(len(txs_of[d]) for d in proposed) / span
        out["consensus_p50_ms"] = 1e3 * float(np.percentile(consensus_lat, 50))
        out["consensus_p95_ms"] = 1e3 * float(np.percentile(consensus_lat, 95))
        out.update(run.samples(first_commit, txs_of, t0, t1, NODE_SAMPLE_SLACK_S))
        out["window_s"] = t1 - t0
    finally:
        for task in clients:
            task.cancel()
        await run.stop()
        del os.environ["HOTSTUFF_CRYPTO_BACKEND"]
        if scenario is not None:
            del os.environ["HOTSTUFF_FAULTLINE"]
            faultline.uninstall()
    return out


def conveyor_phase(seed: int, card: str, device, imad_per_s: float):
    """Phase 11 and the QC kernels at its widths. Returns (launches in the
    measured window, the QC kernels' rows at the widest width)."""
    frozen = freeze_heap()  # what phase 10c left alive, as before it
    t = time.perf_counter()
    run = asyncio.run(conveyor(seed, device))
    phase_s = time.perf_counter() - t
    launches, c = run["launches"], run["counts"]
    print(f"conveyor on {card}: {CONVEYOR_N} port nodes x {CONVEYOR_WORKERS} workers (NativeEngine "
          f"stores, keys from --seed), HOTSTUFF_CRYPTO_BACKEND=cuda-batched, timeout "
          f"{CONVEYOR_TIMEOUT_MS} ms, batch {CONVEYOR_BATCH_BYTES} B, max batch delay "
          f"{CONVEYOR_BATCH_DELAY_MS} ms; {CONVEYOR_N} sharded clients at "
          f"{CONVEYOR_RATE // CONVEYOR_N} tx/s of {CONVEYOR_TX_BYTES} B ({CONVEYOR_RATE} offered); "
          f"booted in {run['boot_s']:.2f} s, first payload commit on every node at "
          f"{run['first_commit_s']:.2f} s; phase {phase_s:.1f} s; before it {frozen}")
    print(f"conveyor on {card}: over {run['window_s']:.2f} s: {run['tx_per_s']:.1f} committed tx/s "
          f"({run['batches_per_s']:.1f} batches/s), consensus {run['consensus_tx_per_s']:.1f} tx/s, "
          f"{run['rounds_per_s']:.2f} rounds/s; end-to-end latency p50 {run['p50_ms']:.1f} ms, "
          f"p95 {run['p95_ms']:.1f} ms ({run['samples']} samples); consensus latency p50 "
          f"{run['consensus_p50_ms']:.1f} ms, p95 {run['consensus_p95_ms']:.1f} ms")
    print(f"conveyor on {card}: in the window {c['shed']} bundles shed by the workers, "
          f"{run['rate_misses']} rate misses (\"Transaction rate too high\"), the clients' last "
          f"shed count {run['client_sheds']}; batches sealed {c['sealed']}, certificates formed "
          f"{c['certs_formed']} (failed {c['certs_failed']}), acks invalid {c['acks_invalid']}, peer "
          f"certificates stored {c['certs_stored']} (rejected {c['certs_rejected']}), batches the "
          f"resolvers fetched {c['fetched']} (unresolved {c['unresolved']}); whole run: "
          f"{run['counts_total']}")
    print(f"conveyor on {card}: every node committed the same {run['payload_blocks']} payload "
          f"blocks; {run['committed_batches']} committed batches read back from all "
          f"{CONVEYOR_N} stores, parse and hash to their digests; {run['certs_verified']} stored "
          f"certificates verified; {run['timeouts']} timeouts; sample transactions sent "
          f"{NODE_SAMPLE_SLACK_S:.0f} s or more before the window's end: {run['expected']}, "
          f"{run['missing']} not committed ({run['unsealed']} never sealed); the garbage "
          f"collector ran {run['gc_pauses']} times in the window ({run['gc_full']} full), the "
          f"longest {run['gc_longest_ms']:.1f} ms")
    print(f"conveyor on {card}: launches " + ", ".join(f"{k} {v}" for k, v in sorted(launches.items()))
          + f"; CudaBackend calls by signatures {run['sig_counts']}")
    check(run["missing"] == 0, f"{run['missing']} of {run['expected']} sample transactions never "
          f"committed ({run['unsealed']} never sealed into a batch)")
    check(run["timeouts"] == 0, f"{run['timeouts']} timeouts fired in the measured window")
    for name in PHASE8_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched on the data plane's path")
    check(launches["msm_partials"] == 0 and launches["sqrt_pow"] == 0,
          f"the data plane's path launched K4 or the root alone: {launches}")
    return launches, width_checks(run["widths"], run["inner"], device, imad_per_s, "conveyor")


# -- phase 12: replica rejoin --------------------------------------------------


class Engine:
    """One seat of phase 12a: its keys, its store directory (a new one for
    each life after a wipe), its live ``Consensus``, the Core of each life,
    every block it committed, and each snapshot it installed."""

    def __init__(self, index: int, keypair, tmp: str) -> None:
        self.index, (self.pk, self.sk), self.tmp = index, keypair, tmp
        self.life = 0
        self.store = self._open()
        self.consensus = self.crashed = None
        self.cores, self.tasks = [], []
        self.commits = []  # (life, monotonic time, block)
        # (monotonic time, record, its committed round before, the others')
        self.installs = []
        self.responses = []  # monotonic times of state responses with a record
        self.at_install = None  # called after each install

    def _open(self) -> Store:
        return Store(engine=LogEngine(f"{self.tmp}/engine_{self.index}_{self.life}"))

    def log_size(self) -> int:
        return self.store._engine.size_bytes()

    async def spawn(self, committee, params, others) -> None:
        rx_mempool, tx_mempool, tx_commit = asyncio.Queue(), asyncio.Queue(), asyncio.Queue()

        async def drain():
            while True:
                await tx_mempool.get()

        async def collect(life=self.life):
            while True:
                block = await tx_commit.get()
                self.commits.append((life, time.monotonic(), block))

        self.consensus = await Consensus.spawn(self.pk, committee, params,
                                               crypto.SignatureService(self.sk), self.store,
                                               rx_mempool, tx_mempool, tx_commit)
        core = self.consensus.core
        self.cores.append(core)
        self.tasks = [asyncio.create_task(drain()), asyncio.create_task(collect())]
        install = core._statesync._install

        async def recorded(snap, raw):
            had = core.last_committed_round
            heads = [o.cores[-1].last_committed_round for o in others() if o is not self]
            await install(snap, raw)
            self.installs.append((time.monotonic(), raw, had, heads))
            if self.at_install is not None:
                self.at_install()

        sync = core._statesync
        respond = sync.handle_state_response

        async def responded(payload):
            if payload[2] is not None:
                self.responses.append(time.monotonic())
            await respond(payload)

        core._statesync._install = recorded
        sync.handle_state_response = responded

    def crash(self) -> None:
        """Unclean, as a process crash (``Consensus.crash``); the store stays
        open."""
        self.consensus.crash()
        for t in self.tasks:
            t.cancel()
        self.crashed, self.consensus = self.consensus, None

    async def restart_wiped(self, committee, params, others) -> None:
        """Back on a new, empty store: the disk was lost."""
        await self.crashed.compactor.drain()
        self.store.close()
        self.life += 1
        self.store = self._open()
        await self.spawn(committee, params, others)

    def blocks(self, life=None) -> list:
        return [b for l, _, b in self.commits if life is None or l == life]

    async def shutdown(self) -> None:
        if self.consensus is not None:
            await self.consensus.shutdown()
        for t in self.tasks:
            t.cancel()
        self.store.close()


def snapshot_calls(victim: Engine, calls: list, t_restart: float) -> dict:
    """The card calls from the restart to the end of the first install
    whose messages hold the vote digest of either of its snapshot's QCs.
    Fails unless each digest is in one, and each such call launched a warm
    QC's kernels and nothing else. Returns their widths, their launches
    summed, and how many began before the first state response that
    carried a record (the chain walk) and how many after it."""
    snap = decode_snapshot(victim.installs[0][1])
    digests = {snap.child.qc.digest().data, snap.cert.digest().data}
    mine = [(t, n, msgs & digests, launches) for t, n, msgs, launches in calls
            if msgs & digests]
    seen = set().union(*(d for _, _, d, _ in mine))
    check(seen == digests, f"{len(digests - seen)} of the snapshot's two QCs never went to the "
          f"card between the restart and the install ({len(calls)} calls in that window)")
    for _, n, _, launches in mine:
        check(launches == WARM_QC_ALL,
              f"a card call of {n} signatures that verified a snapshot QC launched {launches}")
    response = victim.responses[0] if victim.responses else float("inf")
    return {
        "widths": [n for _, n, _, _ in mine],
        "launches": {k: sum(c[3][k] for c in mine) for k in launch_counts()},
        "walk": sum(t < response for t, _, _, _ in mine),
        "verify": sum(t >= response for t, _, _, _ in mine),
        "response_s": response - t_restart,
        "window": len(calls),
    }


def commits_agree(engines) -> None:
    """Every round committed on several engines has one digest there, and an
    engine's commits of one life form a chain: a block's parent is the block
    committed before it, or the frontier of a snapshot it installed above
    that block (no gap above its floor)."""
    by_round = {}
    for e in engines:
        for _, _, b in e.commits:
            by_round.setdefault(b.round, set()).add(b.digest())
        floors = dict(peek_frontier(raw)[::-1] for _, raw, _, _ in e.installs)
        for (l0, _, prev), (l1, _, b) in zip(e.commits, e.commits[1:]):
            if l0 == l1 and b.parent() != prev.digest():
                check(floors.get(b.parent(), -1) >= prev.round,
                      f"engine {e.index}: a gap in its commits at round {b.round}")
    split = [r for r, digests in by_round.items() if len(digests) > 1]
    check(not split, f"the engines committed different blocks at rounds {split}")


async def rejoin(seed: int, device) -> dict:
    """Phase 12a (see the docstring): the cold rejoin of a wiped engine."""
    rng = random.Random(seed * 7919 + 31)
    keys = [crypto.generate_keypair(seed=rng.randbytes(32))[:2] for _ in range(REJOIN_N)]
    committee = Committee({pk: Authority(1, ("127.0.0.1", REJOIN_PORTS + i))
                           for i, (pk, _) in enumerate(keys)})
    params = Parameters(timeout_delay=NODE_TIMEOUT_MS, batch_vote_verification=True,
                        retention_rounds=REJOIN_RETENTION)
    os.environ["HOTSTUFF_CRYPTO_BACKEND"] = "cuda-batched"
    crypto._BACKEND = None
    cert_arena.reset()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rejoin_")
    engines = [Engine(i, keys[i], tmp) for i in range(REJOIN_N)]
    victim = engines[REJOIN_VICTIM]
    survivors = [e for e in engines if e is not victim]
    out, recorder = {}, None
    try:
        index = {pk: i for i, (pk, _) in enumerate(keys)}
        t = time.monotonic()
        for pk in reversed(committee.sorted_keys()):  # descending leader order, as phase 9
            await engines[index[pk]].spawn(committee, params, lambda: engines)
        backend = crypto.get_backend()
        check(isinstance(backend, BatchingBackend) and isinstance(backend.inner, CudaBackend),
              f"HOTSTUFF_CRYPTO_BACKEND=cuda-batched installed {backend!r}")
        recorder = VerifyWidths(backend.inner)
        while not all(e.commits for e in engines):
            check(time.monotonic() - t < NODE_BOOT_S, "no first commit on every engine")
            await asyncio.sleep(0.05)
        t0 = time.monotonic()
        out["boot_s"] = t0 - t
        sizes = {e.index: [e.log_size()] for e in survivors}

        async def until(deadline: float) -> None:
            while time.monotonic() < deadline:
                for e in survivors:
                    sizes[e.index].append(e.log_size())
                await asyncio.sleep(0.05)

        await until(t0 + REJOIN_CRASH_S)
        victim.crash()
        out["victim_round"] = max(b.round for b in victim.blocks())
        await until(t0 + REJOIN_RESTART_S)

        # Every survivor has written a snapshot record and compacted: once
        # its rewrite in flight ends, no block it committed below its floor
        # reads back.
        out["floors"], out["heads"] = {}, {}
        for e in survivors:
            await e.consensus.compactor.drain()
            record = await e.store.read_meta(SNAPSHOT_KEY)
            check(record is not None, f"engine {e.index} wrote no snapshot record in "
                  f"{REJOIN_RESTART_S:.0f} s")
            floor = peek_frontier(record)[0]
            out["floors"][e.index], out["heads"][e.index] = floor, e.cores[-1].last_committed_round
            comp = e.consensus.compactor
            check(comp.compactions >= 1 and comp.bytes_freed > 0,
                  f"engine {e.index} never compacted its store.log")
            for b in e.blocks():
                check(b.round >= floor or await e.store.read(b.digest().data) is None,
                      f"engine {e.index}: round {b.round} below its floor {floor} reads back")

        # The restart, wiped, with the launch counts zeroed and the card's
        # calls logged from just before it to the end of the first install:
        # every engine's launches, and the calls that verified the
        # snapshot's two QCs.
        cert_arena.reset()
        reset_launches()
        calls0 = dict(recorder.sig_counts)
        with recorder.lock:
            recorder.calls = []

        def install_window() -> None:
            if "install_launches" not in out:
                out["install_launches"] = launch_counts()
                with recorder.lock:
                    out["install_calls"] = {n: c - calls0.get(n, 0)
                                            for n, c in recorder.sig_counts.items()
                                            if c > calls0.get(n, 0)}
                    out["window_calls"], recorder.calls = recorder.calls, None

        victim.at_install = install_window
        t_restart = time.monotonic()
        await victim.restart_wiped(committee, params, lambda: engines)
        while len(victim.blocks(1)) < REJOIN_COMMITS:
            check(time.monotonic() - t_restart < REJOIN_RECOVERY_S,
                  f"the wiped engine committed {len(victim.blocks(1))} blocks in "
                  f"{REJOIN_RECOVERY_S:.0f} s after its restart (installs: {len(victim.installs)})")
            await asyncio.sleep(0.01)
        check(victim.installs, "the wiped engine committed without installing a snapshot")
        out["snapshot_calls"] = snapshot_calls(victim, out["window_calls"], t_restart)
        commit_times = [ts for life, ts, _ in victim.commits if life == 1]
        out["first_commit_s"] = commit_times[0] - t_restart
        out["third_commit_s"] = commit_times[REJOIN_COMMITS - 1] - t_restart
        out["installs"] = [(ts - t_restart, peek_frontier(raw)[0], had, heads)
                           for ts, raw, had, heads in victim.installs]
        check(all(fr > had for _, fr, had, _ in out["installs"]),
              f"a snapshot installed at or below what the engine had committed: {out['installs']}")
        commits_agree(engines)
        for e in engines:
            for core in e.cores:
                check(core.backend_failures == 0,
                      f"engine {e.index}: {core.backend_failures} verifications met "
                      f"BackendUnavailable")
        for e in survivors:
            comp = e.consensus.compactor
            sizes[e.index].append(e.log_size())
            out.setdefault("compaction", {})[e.index] = dict(
                compactions=comp.compactions, bytes_freed=comp.bytes_freed,
                keys_dropped=comp.keys_dropped, snapshot_round=comp.snapshot_round,
                log_peak=max(sizes[e.index]), log_now=sizes[e.index][-1])
        out["probes"] = {e.index: sum(c._statesync.probes_sent for c in e.cores) for e in engines}
        out["joiner_installed"] = victim.cores[-1]._statesync.snapshots_installed
    finally:
        if recorder is not None:
            out["widths"], out["sig_counts"] = recorder.stop()
            out["inner"] = recorder.inner
        for e in engines:
            await e.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
        del os.environ["HOTSTUFF_CRYPTO_BACKEND"]
    return out


async def warm_restart(seed: int, device) -> dict:
    """Phase 12b (see the docstring): node 2 of config 1 crashes and
    restarts on its own store."""
    from hotstuff_tpu_torch.node import Committee as NodeCommittee
    from hotstuff_tpu_torch.node import Parameters as NodeParameters
    from hotstuff_tpu_torch.node import Secret
    from hotstuff_tpu_torch.node.client import run_client

    rng = random.Random(seed * 7919 + 37)
    secrets = [Secret(*crypto.generate_keypair(seed=rng.randbytes(32))) for _ in range(NODE_N)]
    base = WARM_PORTS
    consensus = Committee({s.name: Authority(1, ("127.0.0.1", base + i))
                           for i, s in enumerate(secrets)})
    mempool = MempoolCommittee({s.name: MempoolAuthority(
        1, ("127.0.0.1", base + 10 + i), ("127.0.0.1", base + 20 + i))
        for i, s in enumerate(secrets)})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_warm_")
    NodeCommittee(consensus, mempool).write(f"{tmp}/committee.json")
    NodeParameters(
        Parameters(timeout_delay=NODE_TIMEOUT_MS, retention_rounds=REJOIN_RETENTION),
        MempoolParameters(batch_size=NODE_BATCH_BYTES, max_batch_delay=NODE_BATCH_DELAY_MS,
                          device_batch_digests=True),
    ).write(f"{tmp}/parameters.json")
    os.environ["HOTSTUFF_CRYPTO_BACKEND"] = "cuda-batched"
    crypto._BACKEND = None
    cert_arena.reset()

    run = NodeRun(("client", "mempool", "consensus"), tmp, keep_batches=True)
    clients, recorder, out = [], None, {}
    try:
        out["boot_s"] = await run.boot(secrets, device)
        nodes = run.nodes
        recorder = VerifyWidths(crypto.get_backend().inner)
        addresses = [("127.0.0.1", base + 10 + i) for i in range(NODE_N)]
        clients = [run.spawn(i, run_client(
            addresses[i], NODE_TX_BYTES, NODE_RATE // NODE_N, NODE_TIMEOUT_MS, addresses,
            duration=600)) for i in range(NODE_N)]

        def alive():
            for n in nodes:
                check(n.crashed or not n.mempool.failed.done(), "a mempool actor died")

        await run.first_payload_commit(NODE_BOOT_S, alive)
        victim = nodes[WARM_VICTIM]
        out["victim_round"] = victim.consensus.core.last_committed_round
        t_crash = time.time()
        await victim.crash()
        await asyncio.sleep(WARM_DOWN_S)
        record = await victim.store.read_meta(SNAPSHOT_KEY)
        out["heads"] = [n.consensus.core.last_committed_round for n in nodes if not n.crashed]
        t_restart = time.time()
        await victim.restart()
        await asyncio.sleep(0.1)  # the Core's run preamble: its state and its floor
        core = victim.consensus.core
        out["floor"] = peek_frontier(record)[0] if record is not None else None
        out["restored"] = (core.round, core.last_voted_round, core.last_committed_round,
                           core.synchronizer._floor_round)
        if record is not None:
            check(core.synchronizer._floor_round >= out["floor"],
                  f"node {WARM_VICTIM} restarted without the floor of its own record")
        await asyncio.sleep(WARM_WINDOW_S)
        t1 = time.time()
        alive()
        for task in clients:
            task.cancel()
        await asyncio.sleep(NODE_DRAIN_S)
        alive()
        out["timeouts"] = sum(n.consensus.core.timeouts_fired for n in nodes)
        out["backend_failures"] = sum(n.consensus.core.backend_failures for n in nodes)

        # Agreement: one digest a round everywhere; the survivors' payload
        # sequences equal (the last two may be on their way); node 2's, over
        # both its lives, in the same order.
        by_round = {}
        for i in range(NODE_N):
            for _, b in run.commits[i]:
                by_round.setdefault(b.round, set()).add(b.digest())
        check(all(len(d) == 1 for d in by_round.values()), "the nodes committed different blocks")
        seqs = {i: [b.digest() for _, b in run.payload_commits(i)] for i in range(NODE_N)}
        others = [i for i in range(NODE_N) if i != WARM_VICTIM]
        short = min(len(seqs[i]) for i in others)
        check(all(seqs[i][:short] == seqs[others[0]][:short] for i in others),
              "the running nodes committed different sequences of payload blocks")
        order = {d: k for k, d in enumerate(seqs[max(others, key=lambda i: len(seqs[i]))])}
        mine = [order.get(d, -1) for d in seqs[WARM_VICTIM]]
        check(-1 not in mine[:-2] and mine == sorted(mine),
              f"node {WARM_VICTIM}'s payload blocks are not the others' in their order")
        after = [(ts, b) for ts, b in run.commits[WARM_VICTIM] if ts >= t_restart]
        check(after, f"node {WARM_VICTIM} committed nothing after its restart")
        out["first_commit_s"] = after[0][0] - t_restart
        payload_after = [ts for ts, b in after if b.payload]
        out["first_payload_s"] = payload_after[0] - t_restart if payload_after else None
        check(payload_after, f"node {WARM_VICTIM} committed no payload block after its restart")
        out["down_s"] = t_restart - t_crash
        out["rounds_lost"] = max(out["heads"]) - out["victim_round"]

        # Samples sent to the nodes that stayed up, as LogParser pairs them.
        # A block proposed just before a round whose leader is down gets no
        # QC, and every proposer drops the block's payload from its buffer
        # when it processes the block (as in the reference): a sample whose
        # batch was only ever proposed in such a block is lost, and is
        # counted apart. Any other missing sample fails the phase.
        first = {}
        for i in range(NODE_N):
            for ts, b in run.payload_commits(i):
                for d in b.payload:
                    first[d] = min(ts, first.get(d, ts))
        committed_blocks = {b.digest() for i in range(NODE_N) for _, b in run.commits[i]}
        sent, batch_of, proposed = {}, {}, {}
        for i, r in run.records:
            if r.msg == "Sending sample transaction %d" and i != WARM_VICTIM:
                sent[(i, r.args[0])] = r.created
            elif r.msg == "Batch %s contains sample tx %d":
                batch_of[(i, r.args[1])] = r.args[0]
            elif r.msg == "Created %s -> %s":
                proposed.setdefault(r.args[1], []).append(r.args[0])
        expected = [k for k, ts in sent.items() if ts <= t1 - NODE_SAMPLE_SLACK_S]
        check(expected, "no sample transaction was sent")
        missing = [k for k in expected if batch_of.get(k) not in first]
        abandoned = [k for k in missing if batch_of.get(k) in proposed and not any(
            blk.digest() in committed_blocks for blk in proposed[batch_of[k]])]
        for k in expected:
            d = batch_of.get(k)
            if d in first:
                sample = b"\x00" + k[1].to_bytes(8, "big")
                txs = decode_batch(run.batches[d])[1]
                check(any(tx[:9] == sample for tx in txs),
                      f"batch {d!r} lacks the sample transaction {k[1]} it was logged with")
        out.update(expected=len(expected), missing=len(missing), abandoned=len(abandoned))
        check(len(missing) == len(abandoned),
              f"{len(missing) - len(abandoned)} of {len(expected)} sample transactions sent to "
              f"the nodes that stayed up never committed, not explained by an abandoned block")
        latency = sorted(first[batch_of[k]] - sent[k] for k in expected if k not in missing)
        out["p50_ms"] = 1e3 * float(np.percentile(latency, 50))
        out["p95_ms"] = 1e3 * float(np.percentile(latency, 95))
        out["window_s"] = t1 - t_crash
    finally:
        for task in clients:
            task.cancel()
        if recorder is not None:
            out["widths"], out["sig_counts"] = recorder.stop()
        await run.stop()
        del os.environ["HOTSTUFF_CRYPTO_BACKEND"]
    return out


def snapshot_check(keys, committee, seed: int) -> dict:
    """Phase 12c (see the docstring): a snapshot record at N = 1000."""
    from torch.cuda import Event

    reps = 5  # each of the two, twice in turns
    secret = dict(keys)
    leaders = committee.sorted_keys()
    rng = random.Random(seed * 7919 + 41)

    def block(qc: QC, round_: int) -> Block:
        author = leaders[round_ % len(leaders)]
        return Block.new_from_key(qc, None, author, round_, [], secret[author])

    def qc_over(b: Block) -> QC:
        agg, order = Aggregator(committee), list(keys)
        rng.shuffle(order)
        for pk, sk in order:
            qc = agg.add_vote(Vote.new_from_key(b.digest(), b.round, pk, sk))
            if qc is not None:
                return qc
        raise SmokeFailure("no QC formed")

    t = time.perf_counter()
    parent = block(QC.genesis(), 1)
    frontier = block(qc_over(parent), 2)
    child = block(qc_over(frontier), 3)
    cert = qc_over(child)
    sign_s = time.perf_counter() - t
    raw = encode_snapshot(frontier, child, cert)
    snap = decode_snapshot(raw)
    crypto.set_backend("cuda-batched")
    batched = crypto.get_backend()
    check(batched.inner._cache.ensure([pk.data for pk in leaders]),
          "a committee key failed to decompress")
    recorder = VerifyWidths(batched.inner)
    out = {"record_bytes": len(raw), "sign_s": sign_s, "sigs": len(cert.votes)}
    try:
        cert_arena.reset()
        reset_launches()
        calls = batched.inner_calls
        asyncio.run(verify_snapshot(snap, committee))  # raises on rejection
        torch.cuda.synchronize()
        out["launches"] = launch_counts()
        out["inner_calls"] = batched.inner_calls - calls
        check(out["inner_calls"] == 2, f"a snapshot verify made {out['inner_calls']} inner calls")
        expect_two = {name: 2 * n for name, n in WARM_QC_ALL.items()}
        check(out["launches"] == expect_two,
              f"a snapshot verify launched {out['launches']}, expected {expect_two}")

        votes = list(cert.votes)
        pk, sig = votes[len(votes) // 2]
        data = bytearray(sig.data)
        data[5] ^= 0x01
        votes[len(votes) // 2] = (pk, crypto.Signature(bytes(data)))
        forged = decode_snapshot(encode_snapshot(frontier, child, QC(cert.hash, cert.round, votes)))
        cert_arena.reset()
        try:
            asyncio.run(verify_snapshot(forged, committee))
            raise SmokeFailure("a snapshot with a flipped vote byte verified")
        except errors.InvalidSignature:
            pass
        reset_launches()
        try:
            decode_snapshot(encode_snapshot(frontier, child, QC(frontier.digest(), child.round,
                                                                cert.votes)))
            raise SmokeFailure("a snapshot whose cert certifies another block decoded")
        except SnapshotError:
            pass
        check(sum(launch_counts().values()) == 0, "a structurally bad snapshot launched a kernel")

        async def timed(fn) -> list[float]:
            times = []
            for _ in range(reps):
                cert_arena.reset()
                start, end = Event(enable_timing=True), Event(enable_timing=True)
                start.record()
                await fn()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            return times

        async def two_lone() -> None:
            child.qc.verify(committee)
            cert.verify(committee)

        async def both() -> tuple[list[float], list[float]]:
            snap_ms, lone_ms = [], []
            for _ in range(2):  # in turns
                snap_ms += await timed(lambda: verify_snapshot(snap, committee))
                lone_ms += await timed(two_lone)
            return snap_ms, lone_ms

        snap_ms, lone_ms = asyncio.run(both())
        out["snapshot_ms"], out["lone_ms"] = float(np.median(snap_ms)), float(np.median(lone_ms))
    finally:
        out["widths"], out["sig_counts"] = recorder.stop()
        out["inner"] = batched.inner
    return out


def rejoin_phase(seed: int, card: str, device, imad_per_s: float, keys, committee):
    """Phase 12. Returns (every engine's launches from the wiped engine's
    restart to the end of its first install, the launches of the card calls
    that verified its snapshot's QCs then, the QC kernels' rows at the
    widest width)."""
    frozen = freeze_heap()  # what phase 11 left alive, as before it
    t = time.perf_counter()
    a = asyncio.run(rejoin(seed, device))
    a_s = time.perf_counter() - t
    launches, snapshot = a["install_launches"], a["snapshot_calls"]
    for name in PHASE12_KERNELS:
        check(snapshot["launches"][name] > 0,
              f"kernel {name} never launched for the snapshot's QCs")
    check(launches["msm_partials"] == 0 and launches["sqrt_pow"] == 0,
          f"the rejoin launched K4 or the root alone: {launches}")
    print(f"rejoin on {card}: {REJOIN_N} port engines (LogEngine stores, keys from --seed), "
          f"HOTSTUFF_CRYPTO_BACKEND=cuda-batched, timeout {NODE_TIMEOUT_MS} ms, retention "
          f"{REJOIN_RETENTION} rounds; first commit everywhere after {a['boot_s']:.2f} s; engine "
          f"{REJOIN_VICTIM} crashed at {REJOIN_CRASH_S:.0f} s (committed round "
          f"{a['victim_round']}) and restarted wiped at {REJOIN_RESTART_S:.0f} s, the survivors' "
          f"floors {a['floors']} at heads {a['heads']}; phase {a_s:.1f} s; before it {frozen}")
    print(f"rejoin on {card}: time to recover, restart to the joiner's first commit "
          f"{a['first_commit_s'] * 1e3:.1f} ms, to its third {a['third_commit_s'] * 1e3:.1f} ms; "
          f"snapshots installed {len(a['installs'])} (its counter {a['joiner_installed']}): "
          + "; ".join(f"at {ts * 1e3:.1f} ms frontier r{fr} above its r{had} (the others at "
                      f"r{heads})" for ts, fr, had, heads in a["installs"])
          + f"; probes sent {a['probes']}")
    for i, c in sorted(a["compaction"].items()):
        print(f"rejoin on {card}: survivor {i}: {c['compactions']} compactions, {c['bytes_freed']} B "
              f"freed, {c['keys_dropped']} keys dropped, floor r{c['snapshot_round']}, store.log "
              f"peak {c['log_peak']} B, now {c['log_now']} B")
    print(f"rejoin on {card}: from the restart to the end of the first install, every engine's: "
          f"launches " + ", ".join(f"{k} {v}" for k, v in sorted(launches.items()))
          + f"; CudaBackend calls by signatures {a['install_calls']}; whole phase "
          f"{a['sig_counts']}")
    print(f"rejoin on {card}: the snapshot's two QCs went to the card in {len(snapshot['widths'])} "
          f"of those {snapshot['window']} calls, of {snapshot['widths']} signatures, "
          f"{snapshot['walk']} in the joiner's chain walk before the first state response with a "
          f"record ({snapshot['response_s'] * 1e3:.1f} ms after the restart) and "
          f"{snapshot['verify']} in verify_snapshot; their launches "
          + ", ".join(f"{k} {v}" for k, v in sorted(snapshot["launches"].items())))

    frozen = freeze_heap()
    t = time.perf_counter()
    b = asyncio.run(warm_restart(seed, device))
    print(f"warm restart on {card}: config 1 ({NODE_N} port nodes, NativeEngine stores, device "
          f"digests, {NODE_N} clients at {NODE_RATE // NODE_N} tx/s of {NODE_TX_BYTES} B) at "
          f"retention {REJOIN_RETENTION}: node {WARM_VICTIM} crashed at round {b['victim_round']}, "
          f"down {b['down_s']:.2f} s while the others reached {b['heads']} ({b['rounds_lost']} "
          f"rounds lost); restarted on its own store with (round, last vote, last committed, "
          f"floor) {b['restored']} (its record's floor {b['floor']}); time to recover, restart "
          f"to its first commit {b['first_commit_s'] * 1e3:.1f} ms, to its first payload commit "
          f"{b['first_payload_s'] * 1e3:.1f} ms; phase {time.perf_counter() - t:.1f} s; before "
          f"it {frozen}")
    print(f"warm restart on {card}: sample transactions sent to the nodes that stayed up "
          f"{b['expected']}, not committed {b['missing']} (each in a block abandoned by a view "
          f"change: {b['abandoned']}); send-to-commit p50 {b['p50_ms']:.1f} ms, p95 "
          f"{b['p95_ms']:.1f} ms; {b['timeouts']} timeouts; CudaBackend calls by signatures "
          f"{b['sig_counts']}")
    check(b["backend_failures"] == 0, "a verification met BackendUnavailable")

    c = snapshot_check(keys, committee, seed)
    print(f"snapshot check on {card}: N={len(keys)}, a record of {c['record_bytes']} B (two QCs "
          f"of {c['sigs']} votes, signed in {c['sign_s']:.2f} s) verified in {c['inner_calls']} "
          f"inner calls, launches {c['launches']}; a flipped vote byte raised InvalidSignature, a "
          f"cert of another block SnapshotError with no launch; ms per snapshot verify (CUDA "
          f"events, median of 10) {c['snapshot_ms']:.2f}, two lone QC.verify "
          f"{c['lone_ms']:.2f}")
    widths = {**a["widths"], **b["widths"], **c["widths"]}
    return launches, snapshot["launches"], width_checks(widths, c["inner"], device, imad_per_s,
                                                        "rejoin")


# -- phase 13: the sharded verifier --------------------------------------------


def shard_results(d: int, seed: int, device, with_b: bool):
    """Shard results on the card, multiples of the base point from ``seed``:
    ([d, 4, 20], the same or None), whose sum is the identity (the last
    point cancels the rest), each doubled once so its limbs are not the
    affine ones."""
    rng = random.Random(seed)
    pts = [ref.point_mul(rng.getrandbits(250), ref.G) for _ in range(2 * d if with_b else d)]
    total = ref.IDENTITY
    for q in pts[:-1]:
        total = ref.point_add(total, q)
    x, y, z, t = total
    pts[-1] = (-x % ref.P, y, z, -t % ref.P)
    rows = []
    for x, y, z, _ in pts:
        zi = ref.inv(z)
        xa, ya = x * zi % ref.P, y * zi % ref.P
        rows.append(np.stack([fe._int_to_limbs(xa), fe._int_to_limbs(ya), fe.ONE_LIMBS,
                              fe._int_to_limbs(xa * ya % ref.P)]))
    arr = cv.point_double(torch.from_numpy(np.stack(rows).astype(np.int32))).to(device)
    return arr[:d].contiguous(), (arr[d:].contiguous() if with_b else None)


def tree_checks(device, imad_per_s: float, m: int) -> tuple[dict, list[str]]:
    """13a: ``verdict_tree`` against ``verdict_tree_plain`` on the card at
    every width of ``TREE_WIDTHS``, with and without the second results,
    over ``m`` ok flags (the fresh lanes of phase 3's QC); timed. Returns
    the JSON row (8 shards with b: a cached QC on the widest mesh) and the
    lines to print."""
    row, notes = None, []
    for d in TREE_WIDTHS:
        for with_b in (True, False):
            pair = [x for x in shard_results(d, 13_000 + 2 * d + with_b, device, with_b)
                    if x is not None]
            ok = torch.ones(m, dtype=torch.bool, device=device)
            verdict, point = mk.verdict_tree(ok, *pair)
            torch.cuda.synchronize()
            t = time.perf_counter()
            verdict_p, point_p = mk.verdict_tree_plain(ok, *pair)
            torch.cuda.synchronize()
            plain = (time.perf_counter() - t) * 1e3
            err = max_abs_err(point, point_p)
            check(err == 0 and bool(verdict) and bool(verdict_p),
                  f"verdict_tree at d={d}: kernel {bool(verdict)}, plain "
                  f"{bool(verdict_p)}, points differ by {err}")
            check(torch.equal(mk.verdict_tree(None, *pair)[1], point_p),
                  f"verdict_tree's point alone at d={d} differs")
            ok[-1] = False
            check(not bool(mk.verdict_tree(ok, *pair)[0]), "verdict_tree accepted an ok False")
            ok[-1] = True
            adds = (d if with_b else 0) + d - 1
            b_ms, b_by = bound_ms(adds * MULS_PADD + 3 * MULS_PDOUBLE,
                                  m + 320 * d * len(pair) + 1 + 320, imad_per_s)
            ms, ev, pr = kernel_ms(lambda: mk.verdict_tree(ok, *pair), 20,
                                   PROFILER_NAMES["verdict_tree"])
            chain = adds * STAGES_PADD + 3 * STAGES_PDOUBLE
            shape = f"ok [{m}], a{', b' if with_b else ''} [{d}, 4, 20]"
            notes.append(f"verdict_tree {shape}: grid (1, 1) x 128 threads, "
                         f"{usage_note('verdict_tree')}; {ms:.4f} ms (events {ev:.4f}, profiler "
                         f"{pr:.4f}; plain {plain:.1f} ms, bound {b_ms:.6f} ms; serial chain "
                         f"{chain} dependent mul stages)")
            if d == 8 and with_b:
                row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                           shape=shape)
    return row, notes


def moved_r(batch, j: int):
    """``batch`` with signature j's R moved to R + B: a valid point, so every
    lane decompresses and only the combined sum can reject."""
    msgs, pubs, sigs = batch
    sigs = list(sigs)
    sigs[j] = ref.point_compress(ref.point_add(ref.point_decompress(sigs[j][:32]), ref.G)) \
        + sigs[j][32:]
    return msgs, pubs, sigs


def first_signatures(n: int, mf: int, d: int) -> dict[int, int]:
    """The first of ``n`` signatures whose fresh R row lies in each shard of
    ``d`` that holds one (the uncached path's R lanes split the same way)."""
    per = pm._shard_target(mf, d) // d
    firsts = {}
    for j in range(n):
        firsts.setdefault(j // per, j)
    return firsts


def sharded_launches(d: int, cached: bool) -> dict:
    """A warm sharded QC's launches over d shards."""
    want = dict.fromkeys(launch_counts(), 0)
    if cached:
        want.update(decompress=d, msm_partials_signed=2 * d, msm_combine=2 * d, verdict_tree=1)
    else:
        want.update(decompress=d, msm_partials=d, msm_combine=d, verdict_tree=1)
    return want


def mesh_checks(mesh: pm.Mesh, batch, mf: int, unsharded: dict) -> list[int]:
    """13b on one mesh: phase 3's QC accepted on both sharded paths, a warm
    QC's launches exact, and a tampered signature in each shard that holds
    one rejected, each verdict equal to the unsharded path's. Returns the
    shards holding a signature."""
    d = mesh.size
    cache = ov.DevicePointCache(device=mesh.devices[0])
    check(pm.verify_batch_device_cached_sharded(mesh, *batch, cache), f"D={d}: QC rejected")
    for cached in (True, False):
        before = launch_counts()
        if cached:
            ok = pm.verify_batch_device_cached_sharded(mesh, *batch, cache)
        else:
            ok = pm.verify_batch_device_sharded(mesh, *batch)
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in launch_counts().items()}
        check(ok is True, f"D={d}: the warm QC rejected ({'cached' if cached else 'uncached'})")
        want = sharded_launches(d, cached)
        check(got == want, f"D={d}: a warm sharded QC launched {got}, expected {want}")
    firsts = first_signatures(len(batch[0]), mf, d)
    for shard, j in firsts.items():
        bad = moved_r(batch, j)
        got = (pm.verify_batch_device_cached_sharded(mesh, *bad, cache),
               pm.verify_batch_device_sharded(mesh, *bad))
        check(got == unsharded[j] == (False, False),
              f"D={d}: a tampered signature {j} in shard {shard}: sharded {got}, unsharded "
              f"{unsharded[j]}")
    return sorted(firsts)


def sharded_phase(qc: QC, devices: list, card: str) -> dict:
    """13b (or 13c on distinct cards): phase 3's QC through the sharded
    verifiers on meshes of ``devices`` cut to each of ``MESH_WIDTHS``.
    Returns the launches of the sharded runs and ms per QC by width."""
    batch = qc_batch(qc)
    lead = devices[0]
    n = len(batch[0])
    mf = 1 << max(2, (n - 1).bit_length())
    # The unsharded verdicts, outside the counted window: the valid QC and
    # every tampered signature the meshes below use.
    cache_u = ov.DevicePointCache(device=lead)
    check(ov.verify_batch_device_cached(*batch, cache_u) and
          ov.verify_batch_device(*batch, device=lead), "the unsharded paths rejected the QC")
    tampered = sorted({j for d in MESH_WIDTHS for j in first_signatures(n, mf, d).values()})
    unsharded = {j: (ov.verify_batch_device_cached(*moved_r(batch, j), cache_u),
                     ov.verify_batch_device(*moved_r(batch, j), device=lead)) for j in tampered}
    meshes = [pm.make_mesh(devices=devices * d if len(devices) == 1 else devices[:d])
              for d in MESH_WIDTHS if len(devices) == 1 or d <= len(devices)]

    reset_launches()
    holding = {mesh.size: mesh_checks(mesh, batch, mf, unsharded) for mesh in meshes}
    torch.cuda.synchronize()
    launches = launch_counts()

    # ms per QC (host clock around the call, host prep and the one sync
    # included; median of 5), each mesh beside the unsharded calls, in turns.
    times = {"unsharded": ([], [])}
    for mesh in meshes:
        cache = ov.DevicePointCache(device=mesh.devices[0])
        pm.verify_batch_device_cached_sharded(mesh, *batch, cache)  # keys onto the card
        times[mesh.size] = (
            median_ms(lambda: pm.verify_batch_device_cached_sharded(mesh, *batch, cache), 5),
            median_ms(lambda: pm.verify_batch_device_sharded(mesh, *batch), 5))
        times["unsharded"][0].append(
            median_ms(lambda: ov.verify_batch_device_cached(*batch, cache_u), 5))
        times["unsharded"][1].append(
            median_ms(lambda: ov.verify_batch_device(*batch, device=lead), 5))
    for mesh in meshes:
        d, shards = mesh.size, holding[mesh.size]
        print(f"  D={d} over {', '.join(str(x) for x in dict.fromkeys(mesh.devices))}: the "
              f"QC accepted on both sharded paths; a tampered signature in each of shards "
              f"{shards} rejected on both (the other {d - len(shards)} hold padding only); each "
              f"verdict equal to the unsharded path's; warm launches exact; ms per QC on {card}: "
              f"cached {times[d][0]:.2f}, uncached {times[d][1]:.2f}")
    u_cached, u_uncached = times.pop("unsharded")
    print(f"  unsharded on {card} in the same turns: cached {min(u_cached):.2f}-{max(u_cached):.2f}"
          f" ms, uncached {min(u_uncached):.2f}-{max(u_uncached):.2f} ms per QC")
    return {"launches": launches, "times": times,
            "unsharded": (float(np.median(u_cached)), float(np.median(u_uncached)))}


def mesh_phase(qcs, lead, card: str, imad_per_s: float):
    """Phase 13: the tree-combine verdict against its plain version (13a),
    the sharded verifiers on meshes of ``lead`` (13b) and, where more than
    one card is visible, over distinct cards (13c)."""
    t = time.perf_counter()
    n = len(qcs[0].votes)
    tree_row, notes = tree_checks(lead, imad_per_s, 1 << (n - 1).bit_length())
    print(f"verdict_tree vs plain on the card (limb-exact point, equal verdict) at d = "
          f"{', '.join(map(str, TREE_WIDTHS))}, with and without b:")
    for line in notes:
        print("  " + line)
    print(f"sharded verifier, phase 3's QC ({n} signatures), meshes of one card repeated:")
    run = sharded_phase(qcs[0], [lead], card)
    # msm_sharded over 4 shards against the unsharded MSM, on the uncached
    # batch's lanes.
    packed, _ = ov.prepare_batch(*qc_batch(qcs[0]))
    _, pts, digits = ov.uncached_inputs(torch.from_numpy(packed).to(lead))
    got = pm.msm_sharded(pm.make_mesh(devices=[lead] * 4), pts, digits)
    check(cv.to_affine_bytes(got) == cv.to_affine_bytes(mk.msm(pts, digits)),
          "msm_sharded over 4 shards != the unsharded MSM")
    print(f"  msm_sharded over 4 shards of {pts.shape[0] // 4} lanes equals the unsharded "
          f"mk.msm (canonical affine encoding)")
    if torch.cuda.device_count() > 1:
        print(f"13c: the same over {torch.cuda.device_count()} distinct cards:")
        sharded_phase(qcs[0], pm.visible_devices(), card)
    else:
        print("13c: one card visible; the sharded verifier over distinct cards is not run")
    print(f"phase 13 in {time.perf_counter() - t:.1f} s; launches of the sharded runs "
          f"{run['launches']}")
    return run, tree_row


# -- phase 14: the port's bench ------------------------------------------------


def bench_phase(card: str, device, imad_per_s: float):
    """Phase 14. Returns (the cached run's launches, the uncached run's, the
    kernel rows at the bench's widths)."""
    t = time.perf_counter()
    n = bench_torch.DEFAULT_SIGS
    engine = crypto.CpuBackend().engine
    check(engine == "native-rlc", f"CpuBackend's engine is {engine!r}, not native-rlc")
    msgs, pubs, sigs = bench_torch.make_batch(n)
    made_s = time.perf_counter() - t
    cpu_s = bench_torch.bench_cpu(msgs, pubs, sigs)
    cpu_batch_s = bench_torch.bench_cpu_batch(msgs, pubs, sigs)
    # Each run verifies its warm batch, one a pool thread, then the rounds'.
    feed = dict(iters=bench_torch.ITERS, threads=bench_torch.THREADS, rounds=bench_torch.ROUNDS)
    batches = 1 + feed["threads"] + feed["rounds"] * feed["iters"]
    reset_launches()
    dev_s = bench_torch.bench_device_cached(msgs, pubs, sigs, device=device, **feed)
    cached = launch_counts()
    reset_launches()
    cold_s = bench_torch.bench_device(msgs, pubs, sigs, device=device, **feed)
    uncached = launch_counts()
    zeros = dict.fromkeys(cached, 0)
    # The cached run's first verify also decompresses the n committee keys
    # into its cache: one launch more of K1.
    want_cached = {**zeros, "decompress": batches + 1, "msm_partials_signed": 2 * batches,
                   "msm_combine": 2 * batches, "verdict": batches}
    want_uncached = {**zeros, "decompress": batches, "msm_partials": batches,
                     "msm_combine": batches, "verdict": batches}
    check(cached == want_cached, f"the bench's cached path launched {cached}, expected {want_cached}")
    check(uncached == want_uncached,
          f"the bench's uncached path launched {uncached}, expected {want_uncached}")
    result = bench_torch.result_line(n, cpu_s, cpu_batch_s, dev_s, cold_s, engine)
    check(result["card"] == card, f"the bench stamped {result['card']!r}, the card is {card!r}")
    print(json.dumps(result))
    print(f"bench on {card}: {n} signatures made in {made_s:.1f} s; cached {result['value']} "
          f"us/sig, uncached {result['device_cold_us']} us/sig, serial CPU "
          f"{result['cpu_serial_us']} us/sig, native RLC CPU {result['cpu_batch_us']} us/sig; "
          f"{batches} batches a path; launches "
          f"cached {cached}, uncached {uncached}; bench in {time.perf_counter() - t:.1f} s")

    # Each path's host prep alone, on one thread (the pool shares the GIL).
    cache = ov.DevicePointCache(device=device)
    check(cache.ensure(pubs), "a bench key failed to decompress")
    prep_ms = {}
    for path, prep in (("cached", lambda: ov.prepare_batch_cached(msgs, pubs, sigs, cache)),
                       ("uncached", lambda: ov.prepare_batch(msgs, pubs, sigs))):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            prep()
            times.append((time.perf_counter() - t0) * 1e3)
        prep_ms[path] = float(np.median(times))
    print(f"bench host prep alone on the card's host (one thread, host clock, median of 5): "
          f"cached {prep_ms['cached']:.2f} ms, uncached {prep_ms['uncached']:.2f} ms a batch of {n}")

    # The kernels against their plain versions at the bench's widths.
    t = time.perf_counter()
    rows, notes, shapes = kernel_checks((msgs, pubs, sigs), types.SimpleNamespace(_cache=cache),
                                        device, imad_per_s)
    check(shapes == (2048, 2048, 4096), f"the bench's batch ran at mf, mc, m = {shapes}")
    print(f"kernels vs plain on the card at the bench's widths (limb-exact), {n} signatures, "
          f"mf={shapes[0]} mc={shapes[1]} uncached m={shapes[2]}, in {time.perf_counter() - t:.1f} s:")
    for line in notes:
        print("  " + line)
    return cached, uncached, rows


# -- phase 15: faultline on the card -----------------------------------------


async def scenario_run(scenario, n: int, base: int, retention: int, stream: str | None) -> dict:
    """``faultline.run_scenario`` at phase 15's timeout, its trace and
    snapshot records streamed to ``stream`` (the committee_scale bench's
    in-process stream: one emitter for the whole committee, the trace ring
    cleared at its start)."""
    emitter = None
    if stream is not None:
        emitter = telemetry.TelemetryEmitter(
            telemetry.get_registry(), stream, node=f"committee-{n}", interval_s=1.0,
            trace=telemetry.trace_buffer())
        telemetry.trace_buffer().clear()
        emitter.emit()
        emitter.spawn()
    try:
        return await faultline.run_scenario(scenario, n, base_port=base,
                                            timeout_delay=FAULT_TIMEOUT_MS,
                                            retention_rounds=retention)
    finally:
        if emitter is not None:
            await emitter.shutdown()


def fault_run(name: str, scenario, n: int, base: int, retention: int, gate, stream=None) -> dict:
    """One scenario under the installed ``cuda-batched`` backend, its kernel
    launches and ``crypto.dispatch.cuda`` read at its edges under ``gate``.
    Fails unless the verdict is safe and recovered (and the frontier audit
    passes where retention is on), the trace is the compiled schedule's,
    every transition was applied, the faults fired, the cached path's
    kernels launched and K4 and the root alone did not, and the counter
    moved by exactly the verdict's launches. Under a silent leader, the
    plane must have suppressed exactly the proposal frames that node handed
    to its (asyncio) senders for a consensus address while silent, counted
    at the senders (``silent_offered``): whether it has any to send in its
    window (its own round's proposal, or a block in reply to a sync
    request) depends on how fast the rounds ran before the window."""
    names = [f"n{i:03d}" for i in range(n)]
    schedule = scenario.compile(names)
    transitions = sum(1 + (e.until is not None) for e in schedule.events)
    cert_arena.reset()
    registry = telemetry.get_registry()
    silent_offered = 0
    send_framed = simple_sender.SimpleSender._send_framed
    reliable_send = reliable_sender.ReliableSender.send

    def note(address, frame: bytes, off: int) -> None:
        nonlocal silent_offered
        plane, node = faultline.hooks.plane, faultline.hooks.current_node()
        if (plane is not None and node is not None and address in plane.consensus_addrs
                and len(frame) > off and frame[off] == TAG_PROPOSE
                and plane.behavior_active(node, "silent_leader")):
            silent_offered += 1

    def counted_send_framed(self, address, framed):
        note(address, framed, 4)
        return send_framed(self, address, framed)

    async def counted_reliable_send(self, address, data):
        note(address, data, 0)
        return await reliable_send(self, address, data)

    with gate:
        reset_launches()
        before = registry.snapshot()["counters"]
    t = time.perf_counter()
    simple_sender.SimpleSender._send_framed = counted_send_framed
    reliable_sender.ReliableSender.send = counted_reliable_send
    try:
        result = asyncio.run(scenario_run(scenario, n, base, retention, stream))
    finally:
        simple_sender.SimpleSender._send_framed = send_framed
        reliable_sender.ReliableSender.send = reliable_send
    wall_s = time.perf_counter() - t
    with gate:
        launches = launch_counts()
        counters = telemetry.diff_counters(before, registry.snapshot()["counters"])
    dispatched = counters.get("crypto.dispatch.cuda", 0)
    verdict = result["verdict"]
    counts = verdict["injections"]["counts"]
    check(faultline.hooks.plane is None, f"{name}: the plane stayed installed")
    check(verdict["safety"]["ok"], f"{name}: unsafe: {verdict['safety']}")
    check(verdict["liveness"]["recovered"], f"{name}: not recovered: {verdict['liveness']}")
    if retention:
        check(verdict["frontier_availability"]["ok"],
              f"{name}: frontier availability {verdict['frontier_availability']}")
    check(result["trace"] == schedule.trace(), f"{name}: the trace is not the compiled schedule's")
    check(counts["events_applied"] == transitions,
          f"{name}: {counts['events_applied']} of {transitions} transitions applied")
    if name in DROPPING:
        check(counts["send_drops"] > 0, f"{name}: no frame dropped: {counts}")
    for kind, counter in (("crash", "crashes"), ("restart", "restarts")):
        if any(e.kind == kind for e in schedule.events):
            check(counters.get(f"faultline.injected.{counter}", 0) > 0, f"{name}: no {kind} counted")
    behaviors = {e.params["behavior"] for e in schedule.events if e.kind == "byzantine"}
    if "silent_leader" in behaviors:
        check(counts["proposals_suppressed"] == silent_offered,
              f"{name}: the silent leader handed its senders {silent_offered} proposal frames in "
              f"its window and {counts['proposals_suppressed']} were suppressed: {counts}")
    if behaviors - {"silent_leader", "batch_withhold"}:
        check(counters.get("faultline.injected.byzantine_actors", 0) > 0,
              f"{name}: no byzantine actor spawned")
    for kernel in FAULT_KERNELS:
        check(launches[kernel] > 0, f"{name}: kernel {kernel} never launched: {launches}")
    check(launches["msm_partials"] == 0 and launches["sqrt_pow"] == 0,
          f"{name}: K4 or the root alone launched: {launches}")
    check(dispatched == launches["verdict"],
          f"{name}: crypto.dispatch.cuda moved by {dispatched}, the verdict launched "
          f"{launches['verdict']} times")
    return {"verdict": verdict, "launches": launches, "dispatched": dispatched, "wall_s": wall_s,
            "commits": verdict["commits"], "recovery_s": verdict["liveness"]["recovery_s"],
            "silent_offered": silent_offered}


def watch_stream(path: str) -> Watchtower:
    """A port ``Watchtower`` fed every record of the stream at ``path``
    through ``ingest_record``, one line at a time, as the reference's
    follower feeds it, then flushed."""
    watch = Watchtower(WatchtowerConfig())
    with open(path) as f:
        for line in f:
            if line.strip():
                watch.ingest_record(json.loads(line), source=path)
    watch.flush()
    return watch


def withhold_scenario(tmp: str) -> str:
    """Phase 15d's scenario file: node 2 withholds its acks from 2 s to 8 s."""
    path = os.path.join(tmp, "withhold.json")
    faultline.Scenario(
        name="withhold-n2", seed=2201, duration_s=10.0,
        events=[{"kind": "byzantine", "node": 2, "behavior": "batch_withhold",
                 "at": 2.0, "until": 8.0}],
    ).save(path)
    return path


def faultline_phase(seed: int, card: str, device) -> dict:
    """Phase 15. Returns the launches of all its runs together."""
    t_phase = time.perf_counter()
    telemetry.reset_for_tests()
    telemetry.enable()  # before the backend is made: its counters record
    crypto.set_backend("cuda-batched")
    batched = crypto.get_backend()
    check(isinstance(batched, BatchingBackend) and isinstance(batched.inner, CudaBackend),
          f"cuda-batched installed {batched!r}")
    os.environ["HOTSTUFF_CERT_ARENA"] = "1"
    gate = gate_inner(batched)
    total = dict.fromkeys(launch_counts(), 0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_faultline_")
    try:
        # a, b: the scenarios, each run streamed.
        streams = {}
        for name, n, base, retention in FAULT_RUNS + (STORM_RUN,):
            scenario = faultline.Scenario.load(os.path.join(SCENARIO_DIR, name))
            streams[name] = os.path.join(tmp, f"telemetry-{scenario.name}.jsonl")
            run = fault_run(name, scenario, n, base, retention, gate, streams[name])
            for k, v in run["launches"].items():
                total[k] += v
            v = run["verdict"]
            counts = {k: c for k, c in v["injections"]["counts"].items() if c}
            audit = v.get("frontier_availability")
            print(f"faultline on {card}: {name} at N={n} (seed {scenario.seed}, {scenario.duration_s:g} s,"
                  f" timeout {FAULT_TIMEOUT_MS} ms, retention {retention}): safe, recovered "
                  f"{run['recovery_s']} s after the last heal at {v['liveness']['heal_t']:g} s; "
                  f"commits per node {sorted(set(run['commits'].values()))}, post-heal "
                  f"{min(v['liveness']['post_heal_commits'].values())}-"
                  f"{max(v['liveness']['post_heal_commits'].values())}; injections {counts}"
                  + (f"; frontier audit ok, {audit['checked']} blocks, floors "
                     f"{sorted(set(audit['floors'].values()))}" if audit else "")
                  + (f"; proposal frames the silent leader sent in its window {run['silent_offered']}"
                     if any(e.get("behavior") == "silent_leader" for e in scenario.events) else "")
                  + f"; launches " + ", ".join(f"{k} {c}" for k, c in sorted(run["launches"].items()))
                  + f"; crypto.dispatch.cuda +{run['dispatched']} = verdict launches; "
                  f"run {run['wall_s']:.1f} s")

        # c: the watchtower on a fault-free run, then on b's storm.
        quiet = faultline.Scenario(name="quiet-n4", seed=seed + 1500, duration_s=8.0, events=[])
        quiet_stream = os.path.join(tmp, "telemetry-quiet-n4.jsonl")
        run = fault_run("quiet", quiet, 4, QUIET_PORTS, 0, gate, quiet_stream)
        for k, v in run["launches"].items():
            total[k] += v
        report = validate_stream(quiet_stream)
        check(report["ok"], f"the fault-free stream fails its schemas: {report['problems'][:3]}")
        watch = watch_stream(quiet_stream)
        board = watch.scoreboard()
        check(watch.alerts == [], f"the watchtower raised {len(watch.alerts)} alerts on a fault-free "
              f"run: {[(a['detector'], a['accused']) for a in watch.alerts]}")
        check(board["rounds"] > 0, "the watchtower scored no round of the fault-free run")
        print(f"faultline on {card}: watchtower on the fault-free run (N=4, 8 s, "
              f"{sum(report['counts'].values())} records {report['counts']}): 0 alerts, "
              f"{board['rounds']} rounds scored, frontier {board['frontier']}; scores "
              + ", ".join(f"{p[:6]} {s['score']}" for p, s in sorted(board['peers'].items()))
              + f"; run {run['wall_s']:.1f} s")
        watch = watch_stream(streams["storm-n20.json"])
        board = watch.scoreboard()
        print(f"faultline on {card}: watchtower on the storm-n20 run: {len(watch.alerts)} alerts "
              f"{[(a['detector'], a['accused'], a['confidence']) for a in watch.alerts]}; "
              f"{board['rounds']} rounds scored, frontier {board['frontier']}")
    finally:
        del batched.inner.verify_batch  # the class's method again
        shutil.rmtree(tmp, ignore_errors=True)

    # d: batch_withhold through the node hook, on phase 11's data plane.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_withhold_")
    try:
        registry = telemetry.get_registry()
        withheld0 = registry.snapshot()["counters"].get("faultline.injected.acks_withheld", 0)
        t = time.perf_counter()
        run = asyncio.run(conveyor(seed, device, WITHHOLD_PORTS, withhold_scenario(tmp)))
        wall_s = time.perf_counter() - t
        withheld = registry.snapshot()["counters"].get("faultline.injected.acks_withheld", 0) - withheld0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = run["launches"]
    for k, v in launches.items():
        total[k] += v
    c = run["counts"]
    print(f"faultline on {card}: batch_withhold on node 2 from 2 s to 8 s of a 10 s scenario "
          f"(HOTSTUFF_FAULTLINE, one shared plane, each node booted in a task of its own), phase "
          f"11's data plane at {CONVEYOR_RATE} tx/s: {withheld} acks withheld; over "
          f"{run['window_s']:.2f} s {run['tx_per_s']:.1f} committed tx/s, e2e p50 "
          f"{run['p50_ms']:.1f} ms, p95 {run['p95_ms']:.1f} ms; {run['expected']} samples, "
          f"{run['missing']} not committed; certificates formed {c['certs_formed']} (failed "
          f"{c['certs_failed']}), {run['timeouts']} timeouts; launches "
          + ", ".join(f"{k} {v}" for k, v in sorted(launches.items())) + f"; run {wall_s:.1f} s")
    check(withheld > 0, "node 2 withheld no ack")
    check(run["missing"] == 0, f"{run['missing']} of {run['expected']} sample transactions never "
          "committed under batch_withhold")
    for name in FAULT_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched under batch_withhold")
    check(launches["msm_partials"] == 0 and launches["sqrt_pow"] == 0,
          f"the withholding run launched K4 or the root alone: {launches}")
    telemetry.reset_for_tests()
    telemetry.disable()
    cert_arena.reset()
    print(f"faultline on {card}: phase 15 in {time.perf_counter() - t_phase:.1f} s; launches in all "
          + ", ".join(f"{k} {v}" for k, v in sorted(total.items())))
    return total


# -- phase 16: the native plane on the card ----------------------------------------


def per_round(run: dict) -> str:
    r = len(run["rounds"])
    launches = run["launches"]
    return (f"per round {run['inner_calls'] / r:.2f} inner verify calls, {run['sigs'] / r:.1f} "
            f"signatures; launches per round decompress {launches['decompress'] / r:.2f}, K2 "
            f"{launches['msm_partials_signed'] / r:.2f}, K3 {launches['msm_combine'] / r:.2f}, "
            f"verdict {launches['verdict'] / r:.2f}, K4 {launches['msm_partials'] / r:.2f}")


def native_child(seed: int, card: str, device, phase9_ms: float) -> dict:
    """Phase 16 in the child that ``native_phase`` starts: parts a-d on the
    native transport (and 16c on native stores). Returns each part's
    launches."""
    t_phase = time.perf_counter()
    check(network.Receiver is native_net.NativeReceiver
          and network.SimpleSender is native_net.NativeSimpleSender
          and network.ReliableSender is native_net.NativeReliableSender,
          f"HOTSTUFF_NET=native left the transport at {network.Receiver!r}")
    kernel_build.load_all()
    out = {}

    # a. phase 9's committee, with telemetry on for crypto.dispatch.cuda.
    telemetry.reset_for_tests()
    telemetry.enable()  # before the backend is made: its counters record
    crypto.set_backend("cuda-batched")
    batched = crypto.get_backend()
    check(isinstance(batched, BatchingBackend) and isinstance(batched.inner, CudaBackend),
          f"cuda-batched installed {batched!r}")
    cert_arena.reset()
    t = time.perf_counter()
    try:
        run = asyncio.run(committee(COMMITTEE_N, seed, NATIVE_N100_PORTS, COMMITTEE_ROUNDS))
    finally:
        telemetry.reset_for_tests()
        telemetry.disable()
    phase_s = time.perf_counter() - t
    check_committee_launches(run, "16a")
    dispatched = run["telemetry"]["counters"].get("crypto.dispatch.cuda", 0)
    check(dispatched == run["launches"]["verdict"],
          f"16a: crypto.dispatch.cuda moved by {dispatched}, the verdict launched "
          f"{run['launches']['verdict']} times")
    nat = run["native"]
    check(nat["votes_batched"] > 0, f"16a: the C++ pre-stage batched no vote: {nat}")
    print(f"native 16a on {card}: N={run['n']} (quorum {run['quorum']}) on the native transport "
          f"under cuda-batched (telemetry on), first commit after {run['boot_s']:.2f} s, "
          f"{COMMITTEE_ROUNDS} rounds {run['rounds'][0]}-{run['rounds'][-1]}, every engine committing "
          f"the same digest, no timeout: {run['ms_per_round']:.2f} ms per committed round against "
          f"{phase9_ms:.2f} ms on asyncio in phase 9 of this call; phase {phase_s:.1f} s")
    print(f"native 16a on {card}: C++ pre-stage votes_batched {nat['votes_batched']}, votes_dropped "
          f"{nat['votes_dropped']}, votes_dropped_dup {nat['votes_dropped_dup']}; "
          f"crypto.dispatch.cuda +{dispatched} = verdict launches; {per_round(run)}")
    out["n100"] = run["launches"]
    ms = {"n100": run["ms_per_round"]}

    # b. BASELINE config 4 in protocol mode: N = 1000.
    crypto.set_backend(BatchingBackend(batched.inner, max_sigs=batched.max_sigs))
    cert_arena.reset()
    t = time.perf_counter()
    run = asyncio.run(committee(NATIVE_N, seed, NATIVE_PORTS, NATIVE_ROUNDS))
    phase_s = time.perf_counter() - t
    check_committee_launches(run, "16b")
    nat = run["native"]
    print(f"native 16b on {card}: BASELINE config 4 in protocol mode, N={run['n']} (f="
          f"{(run['n'] - 1) // 3}, quorum {run['quorum']}) on the native transport under "
          f"cuda-batched, cert and decode arenas on, wire v2, batched vote verification, timeout "
          f"{COMMITTEE_TIMEOUT_MS} ms; RLIMIT_NOFILE soft {FD_LIMITS[1]} (hard {FD_LIMITS[2]}), "
          f"{run['fds']} fds open at the peak; first commit on every engine after "
          f"{run['boot_s']:.2f} s (round {run['first_round']}), then {NATIVE_ROUNDS} timed rounds "
          f"{run['rounds'][0]}-{run['rounds'][-1]} (committee_scale's default is 20; cut to "
          f"{NATIVE_ROUNDS} to keep the run under 15 minutes), every engine committing the same "
          f"digest, no timeout: {run['ms_per_round']:.2f} ms per committed round, "
          f"{1e3 / run['ms_per_round']:.3f} rounds/s; phase {phase_s:.1f} s")
    print(f"native 16b on {card}: {per_round(run)}; C++ pre-stage votes_batched "
          f"{nat['votes_batched']}, votes_dropped {nat['votes_dropped']}, votes_dropped_dup "
          f"{nat['votes_dropped_dup']}; out_conns {nat['out_conns']:+d}, frames_rx "
          f"{nat['frames_rx']}, frames_tx {nat['frames_tx']}")
    out["n1000"] = run["launches"]
    ms["n1000"] = run["ms_per_round"]

    # c. BASELINE config 1 on the native transport and native stores.
    frozen = freeze_heap()
    t = time.perf_counter()
    run = asyncio.run(config1(seed, device, NATIVE_NODE_PORTS))
    phase_s = time.perf_counter() - t
    launches = run["launches"]
    check(run["engines"] == ["NativeEngine"] * NODE_N, f"16c: the stores opened {run['engines']}")
    check(run["timeouts"] == 0, f"16c: {run['timeouts']} timeouts fired in the measured window")
    for name in FAULT_KERNELS:
        check(launches[name] > 0, f"16c: kernel {name} never launched")
    check(launches["msm_partials"] == 0 and launches["sqrt_pow"] == 0,
          f"16c: K4 or the root alone launched: {launches}")
    print(f"native 16c on {card}: config 1 ({NODE_N} port nodes, stores {run['engines']}, native "
          f"transport, HOTSTUFF_CRYPTO_BACKEND=cuda-batched, device digests on, {NODE_N} clients at "
          f"{NODE_RATE // NODE_N} tx/s of {NODE_TX_BYTES} B): over {run['window_s']:.2f} s "
          f"{run['tx_per_s']:.1f} committed tx/s, e2e p50 {run['p50_ms']:.1f} ms, p95 "
          f"{run['p95_ms']:.1f} ms ({run['samples']} samples), {run['rounds_per_s']:.2f} rounds/s; "
          f"every node committed the same {run['payload_blocks']} payload blocks, every sample "
          f"committed, no timeout; launches " + ", ".join(f"{k} {v}" for k, v in sorted(launches.items()))
          + f"; phase {phase_s:.1f} s; before it {frozen}")
    out["config1"] = launches

    # d. faultline's partition.json at N = 4 on the native plane.
    telemetry.reset_for_tests()
    telemetry.enable()
    crypto.set_backend("cuda-batched")
    batched = crypto.get_backend()
    gate = gate_inner(batched)
    scenario = faultline.Scenario.load(os.path.join(SCENARIO_DIR, "partition.json"))
    try:
        run = fault_run("partition.json", scenario, 4, NATIVE_FAULT_PORTS, 0, gate)
    finally:
        del batched.inner.verify_batch  # the class's method again
        telemetry.reset_for_tests()
        telemetry.disable()
        cert_arena.reset()
    v = run["verdict"]
    counts = {k: c for k, c in v["injections"]["counts"].items() if c}
    print(f"native 16d on {card}: partition.json at N=4 (seed {scenario.seed}, consensus receivers "
          f"and vote broadcasts on the C++ engine): safe, recovered {run['recovery_s']} s after the "
          f"last heal at {v['liveness']['heal_t']:g} s, trace = the compiled schedule; injections "
          f"{counts}; launches " + ", ".join(f"{k} {c}" for k, c in sorted(run["launches"].items()))
          + f"; crypto.dispatch.cuda +{run['dispatched']} = verdict launches; run "
          f"{run['wall_s']:.1f} s")
    out["faultline"] = run["launches"]
    out["ms"] = ms
    print(f"native: phase 16 (child) in {time.perf_counter() - t_phase:.1f} s")
    return out


def native_phase(seed: int, phase9_ms: float) -> tuple[dict, dict]:
    """Phase 16: runs ``native_child`` in a child process with
    ``NATIVE_ENV`` set, prints its lines, and fails unless it exits 0 within
    ``NATIVE_TIMEOUT_S`` with every part's line and its result line.
    Returns the child's launches by part, and 16a's and 16b's ms per
    committed round."""
    t = time.perf_counter()
    env = {**os.environ, **NATIVE_ENV}
    env.pop("HOTSTUFF_CRYPTO_BACKEND", None)
    cmd = [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
           "--native-child", repr(phase9_ms)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env)
    lines = []
    timer = threading.Timer(NATIVE_TIMEOUT_S, proc.kill)
    timer.start()
    try:
        for line in proc.stdout:
            line = line.rstrip("\n")
            lines.append(line)
            if not line.startswith(NATIVE_RESULT):
                print(line, flush=True)
        code = proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(code == 0, f"phase 16's child exited {code} (killed after {NATIVE_TIMEOUT_S} s: "
          f"{time.perf_counter() - t >= NATIVE_TIMEOUT_S})")
    for part in ("16a", "16b", "16c", "16d"):
        check(any(line.startswith(f"native {part} ") for line in lines),
              f"phase 16's child printed no line of {part}")
    results = [line for line in lines if line.startswith(NATIVE_RESULT)]
    check(len(results) == 1, "phase 16's child printed no result line")
    out = json.loads(results[0][len(NATIVE_RESULT):])
    ms = out.pop("ms")
    print(f"native: phase 16 in {time.perf_counter() - t:.1f} s (HOTSTUFF_NET=native, "
          f"HOTSTUFF_CRYPTO_WORKERS=32, the child's start and kernel load included)")
    return out, ms


def mem_gib(path: str, field: str) -> float:
    """A ``kB`` field of a ``/proc`` status file, in GiB."""
    with open(path) as f:
        for line in f:
            if line.startswith(field + ":"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def group_host_state(rt) -> str:
    """What the host gives the groups: load average, CPU affinity (this
    process's and each group's), each group's CPU seconds so far, and the
    card's memory in use and utilisation."""
    def cpu_s(pid: int) -> float:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")

    alive = [g.process.pid for g in rt.groups if g.process is not None and g.process.is_alive()]
    return (f"load {os.getloadavg()[0]:.1f}; host memory available {mem_gib('/proc/meminfo', 'MemAvailable'):.1f} GiB, "
            f"resident: this process {mem_gib('/proc/self/status', 'VmRSS'):.1f} GiB, the groups "
            f"{sum(mem_gib(f'/proc/{pid}/status', 'VmRSS') for pid in alive):.1f} GiB; "
            f"CPUs for this process {len(os.sched_getaffinity(0))}"
            f" of {os.cpu_count()}, for each group "
            + "/".join(str(len(os.sched_getaffinity(pid))) for pid in alive)
            + "; CPU s per group " + "/".join(f"{cpu_s(pid):.1f}" for pid in alive)
            + f"; card memory used, utilisation: {nvidia_smi('memory.used,utilization.gpu')}")


def grouped_committee(shape: tuple, env: dict) -> dict:
    """One committee sharded over worker processes by ``EngineGroupRuntime``
    (spawned, ``env`` set for them, their standard error to a file of their
    own so that a flood of warnings cannot block their event loops): its
    ``measure`` (each group's ready time, the first commit on every node,
    the timed rounds and their stall bound: a node's round timer fires only
    after a timeout without a round advance, and every commit advances its
    round), each group's open descriptors at the window's end, then stop
    with every group's final telemetry snapshot and launches. Fails unless
    the groups spawned and every node committed every timed round (printing
    the host's state and the merged counters when they stall);
    ``groups_phase`` checks the rest."""
    n, groups, base, rounds = shape
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    log = tempfile.NamedTemporaryFile("w+", prefix="groups-", suffix=".log")
    stderr = os.dup(2)
    t0 = time.perf_counter()
    rt = EngineGroupRuntime(n, groups, base_port=base, timeout_delay=COMMITTEE_TIMEOUT_MS)
    merged = None
    try:
        os.dup2(log.fileno(), 2)  # the spawned groups inherit it
        try:
            rt.start()
        finally:
            os.dup2(stderr, 2)
        kinds = {type(g.process).__name__ for g in rt.groups}
        try:
            per_round = rt.measure(rounds, boot_timeout=GROUP_BOOT_S, round_timeout=GROUP_ROUNDS_S)
        except (TimeoutError, RuntimeError):
            print(f"groups N={n}: no progress; commits per node min {min(rt.commit_counts)} max "
                  f"{max(rt.commit_counts)}; timing {rt.timing}; {group_host_state(rt)}", flush=True)
            merged = rt.stop()
            print(f"groups N={n}: merged counters " + json.dumps(
                {k: v for k, v in sorted(merged["counters"].items())
                 if k.startswith(("consensus.", "crypto.", "net."))}), flush=True)
            raise
        fds = {g.group_id: len(os.listdir(f"/proc/{g.process.pid}/fd")) for g in rt.groups}
        host = group_host_state(rt)
    finally:
        if merged is None:
            merged = rt.stop()
        os.close(stderr)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log.seek(0)
    lines = log.read().splitlines()
    log.close()
    timeouts = {}
    for line in lines:
        if line.startswith("Timeout reached for round "):
            r = int(line.rsplit(" ", 1)[1])
            timeouts[r] = timeouts.get(r, 0) + 1
    check(kinds == {"SpawnProcess"}, f"the groups started as {kinds}")
    per_group = {g.group_id: g.telemetry or {} for g in rt.groups}
    rings = {key: sum(r.get(key, 0) for name, r in merged["rings"].items()
                      if not name.endswith(".parent"))
             for key in ("pushes", "push_bytes", "wraps")}
    rings.update({key: sum(r["events"][key] for name, r in merged["rings"].items()
                           if name.endswith(".parent")) for key in ("polls", "pops")})
    return {"n": n, "groups": groups, "rounds": rounds, "ms_per_round": per_round * 1e3,
            "ready_s": rt.timing["ready_s"], "host": host,
            "first_commit_s": rt.timing["first_commit_s"], "stall_s": rt.timing["stall_s"],
            "fds": fds, "counters": merged["counters"], "launches": merged["launches"],
            "per_group": per_group, "rings": rings, "wall_s": time.perf_counter() - t0,
            "log_lines": len(lines), "timeouts": timeouts}


def groups_phase(card: str) -> dict:
    """Phase 17a-b: engine groups at BASELINE config 2's shape and config
    4's in protocol mode. Returns each part's run, its launches those the
    groups counted and ``stop`` summed."""
    out = {}
    counter = "crypto.dispatch.cuda"
    env_note = ", ".join(f"{k}={v}" for k, v in sorted(GROUP_ENV.items()))
    for part, shape in (("17a", GROUPS_N100), ("17b", GROUPS_N1000)):
        run = grouped_committee(shape, GROUP_ENV)
        n, groups, base, rounds = shape
        c, launches = run["counters"], run["launches"]
        dispatched = c.get(counter, 0)
        print(f"groups {part} on {card}: N={n} (quorum {2 * ((n - 1) // 3) + 1}) in {groups} "
              f"spawned engine groups (node i in group i % {groups}; {env_note}), ports "
              f"{base}-{base + n - 1}, timeout {COMMITTEE_TIMEOUT_MS} ms; groups ready "
              f"{min(run['ready_s'].values()):.2f}-{max(run['ready_s'].values()):.2f} s and the "
              f"first commit on every node {run['first_commit_s']:.2f} s after the start, then "
              f"{rounds} timed rounds "
              + (f"(committee_scale's default is 20; cut to {rounds}, as 16b) " if n == 1000 else "")
              + f"every node committing each: {run['ms_per_round']:.2f} ms per committed round, "
              f"{1e3 / run['ms_per_round']:.3f} rounds/s; fds at the window's end "
              f"{sum(run['fds'].values())} summed over the groups "
              f"({', '.join(str(v) for v in run['fds'].values())}); "
              f"every node's longest wait for a commit reaching into the timed rounds "
              f"{run['stall_s']:.2f} s (under the {COMMITTEE_TIMEOUT_MS / 1e3:.0f} s timeout: no "
              f"timer fired in them); over the whole run consensus.timeouts_fired "
              f"{c.get('consensus.timeouts_fired', 0)} (by round in the groups' "
              f"{run['log_lines']} log lines: {run['timeouts'] or 'none'}), tcs_formed "
              f"{c.get('consensus.tcs_formed', 0)}; run {run['wall_s']:.1f} s; at the window's "
              f"end {run['host']}")
        print(f"groups {part} on {card}: per group {counter} / _sigs / launches decompress, K2, "
              f"K3, verdict: " + ", ".join(
                  f"g{gid} {t.get('counters', {}).get(counter, 0)} / "
                  f"{t.get('counters', {}).get(counter + '_sigs', 0)} / " + ", ".join(
                      str(t.get("launches", {}).get(k, 0)) for k in PHASE8_KERNELS)
                  for gid, t in run["per_group"].items())
              + f"; merged {dispatched} calls, {c.get(counter + '_sigs', 0)} signatures, launches "
              f"{launches}, consensus.blocks_committed {c.get('consensus.blocks_committed', 0)}; "
              f"merged parallel.ring.* pushes {run['rings']['pushes']}, push_bytes "
              f"{run['rings']['push_bytes']}, wraps {run['rings']['wraps']}, parent polls "
              f"{run['rings']['polls']}, pops {run['rings']['pops']}")
        check(run["stall_s"] < COMMITTEE_TIMEOUT_MS / 1e3,
              f"{part}: a node went {run['stall_s']:.1f} s without a commit into the timed rounds")
        for gid, t in run["per_group"].items():
            calls = t.get("counters", {}).get(counter, 0)
            check(calls > 0, f"{part}: group {gid}'s {counter} never moved")
            # A call still in flight when the group read its counts has its
            # dispatch counted and may not have launched yet: verdict <= calls.
            check(0 < t.get("launches", {}).get("verdict", 0) <= calls,
                  f"{part}: group {gid} made {calls} card calls and launched {t.get('launches')}")
        for name in PHASE8_KERNELS:
            check(launches.get(name, 0) > 0, f"{part}: kernel {name} never launched in the groups")
        out[part] = run
    return out


def sim_start() -> dict:
    """Phase 17c's two children, started together (each a single-threaded
    simulation on the host): ``sim_sweep --seeds 0:300 --twins 24
    --inject-wedge --gate`` and ``detector_sweep --config preset:tuned-n4
    --gate``. ``sim_phase`` waits for them and checks what they wrote."""
    seeds, labeled, controls = DETECTOR_SWEEP
    tmp = tempfile.mkdtemp(prefix="phase17c-")
    return {"tmp": tmp, "t": time.perf_counter(), "sim": start_script("sim_sweep", [
        "--seeds", f"0:{SIM_SEEDS}", "--twins", str(SIM_TWINS), "--inject-wedge", "--gate",
        "--artifacts", tmp, "--out", os.path.join(tmp, "sim.json")], harness_env()),
        "sweep": start_script("detector_sweep", [
            "--seeds", f"0:{seeds}", "--labeled-seeds", str(labeled), "--controls",
            str(controls), "--config", "preset:tuned-n4", "--gate", "--out",
            os.path.join(tmp, "sweep.json")], harness_env())}


def sim_phase(card: str, children: dict) -> dict:
    """Phase 17c: the sim plane on the card's host through the port's
    scripts, each from its command line (each sets the ``cpu`` backend for
    its process: the sim verifies inline and launches nothing). ``sim_sweep``:
    every chaos seed and twins scenario safe and recovered under the
    checker, the injected wedge shrunk to a reproducer of its two crashes
    that replays here to the liveness violation; ``detector_sweep`` on a
    labelled corpus: recall 1.0 on the pinned incidents, no alert on a
    control, and the preset's fingerprint."""
    seeds, labeled, controls = DETECTOR_SWEEP
    tmp = children["tmp"]
    joined = time.perf_counter() - children["t"]
    try:
        _, secs = finish_script(children["sim"])
        with open(os.path.join(tmp, "sim.json")) as f:
            summary = json.load(f)
        totals = summary["totals"]
        check(summary["failures"] == [] and totals["ok"] == SIM_SEEDS + SIM_TWINS
              and totals["twins_runs"] == SIM_TWINS, f"17c: sim_sweep's totals {totals}")
        (wedge,) = summary["injected"]
        check(wedge["violation"] == "liveness" and wedge["artifact"],
              f"17c: the injected wedge gave {wedge}")
        with open(wedge["artifact"]) as f:
            repro = json.load(f)
        crashes = [e for e in repro["scenario"]["events"] if e["kind"] == "crash"]
        check(len(crashes) == 2, f"17c: the wedge shrank to {repro['scenario']['events']}")
        world = {k: v for k, v in repro["world"].items() if k != "twins"}
        saved_backend = crypto._BACKEND
        crypto.set_backend("cpu")
        try:
            replayed = sim_failure_probe(repro["n"], **world)(
                faultline.Scenario.from_json(repro["scenario"]))[0]
        finally:
            crypto.set_backend(saved_backend)
            crypto.enable_verify_memo(False)
        check(replayed == "liveness", f"17c: the reproducer replayed to {replayed}")

        _, sweep_s = finish_script(children["sweep"])
        with open(os.path.join(tmp, "sweep.json")) as f:
            sweep = json.load(f)
        gate = sweep["gate"]
        check(gate["ok"] and gate["recall_pinned"] == 1.0 and gate["control_alerts"] == 0
              and sweep["tuned"]["config_hash"] == TUNED_N4, f"17c: detector_sweep's gate {gate}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"sim 17c on the host of {card}: sim_sweep --seeds 0:{SIM_SEEDS} --twins {SIM_TWINS} "
          f"--inject-wedge --gate (cpu, set by the script): {totals['runs']} schedules, "
          f"{totals['events_simulated']} events in {totals['wall_s']} s = "
          f"{totals['schedules_per_min']} seeds a minute, every chaos seed and twins scenario "
          f"safe and recovered; the wedge shrank to {wedge['shrunk_events']} events "
          f"({wedge['shrink_runs']} probe runs) and its reproducer replays here to the liveness "
          f"violation; child {secs:.1f} s")
    print(f"sim 17c on the host of {card}: detector_sweep --seeds 0:{seeds} --labeled-seeds "
          f"{labeled} --controls {controls} --config preset:tuned-n4 --gate: "
          f"{sweep['tuned']['schedules']} schedules, {sweep['tuned']['incidents']} incidents; "
          f"tuned ({TUNED_N4}) recall_pinned {gate['recall_pinned']}, precision "
          f"{gate['precision_vs_default'][0]} against the default's "
          f"{gate['precision_vs_default'][1]}, control alerts {gate['control_alerts']}; "
          f"{sweep['tuned']['timing']['schedules_per_min']} schedules a minute; child {sweep_s:.1f} s; "
          f"both children beside phases 3-5, which took {joined:.1f} s; "
          f"{time.perf_counter() - children['t']:.1f} s from their start to this line")
    return {"per_min": totals["schedules_per_min"], "detector": gate}


# -- phase 18: the measurement harness on the card -----------------------------


def harness_env(**switches: str) -> dict:
    """The environment of a phase 17c, 18 or 19 child: this process's, without any
    ``HOTSTUFF_*`` switch an earlier phase set, plus ``switches``."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("HOTSTUFF_")}
    env.update(switches)
    return env


def kill_session(proc: subprocess.Popen) -> None:
    """``proc`` and every process it started, killed and reaped."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    if proc.poll() is None:
        proc.wait()


# Every child ``start_script`` started; whatever is still running when this
# process exits (a check failed while it ran) is killed with it.
STARTED: list[subprocess.Popen] = []
atexit.register(lambda: [kill_session(proc) for proc in STARTED])


def start_script(module: str, args: list[str], env: dict, cwd: str = REPO) -> dict:
    """``python -m hotstuff_tpu_torch.benchmark.<module> args`` as a user
    types it in ``cwd``, started in a session of its own with its standard
    output in a temporary file; ``finish_script`` waits for it."""
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, "-m", f"hotstuff_tpu_torch.benchmark.{module}", *args],
                            stdout=out, text=True, env=env, cwd=cwd, start_new_session=True)
    STARTED.append(proc)
    return {"proc": proc, "out": out, "what": f"{module} {' '.join(args)}",
            "t": time.perf_counter()}


def finish_script(child: dict, exit_codes: tuple[int, ...] = (0,)) -> tuple[list[str], float]:
    """Waits for a ``start_script`` child: its standard output printed and
    returned with its seconds. Fails unless it exits with one of
    ``exit_codes`` within ``HARNESS_TIMEOUT_S`` of its start; every process
    it started is killed after it."""
    proc, what = child["proc"], child["what"]
    try:
        proc.wait(timeout=max(1.0, HARNESS_TIMEOUT_S - (time.perf_counter() - child["t"])))
        timed_out = False
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        kill_session(proc)
    secs = time.perf_counter() - child["t"]
    child["out"].seek(0)
    lines = child["out"].read().splitlines()
    child["out"].close()
    check(not timed_out, f"{what} ran past {HARNESS_TIMEOUT_S} s")
    for line in lines:
        print(f"  | {line}")
    check(proc.returncode in exit_codes, f"{what} exited {proc.returncode}")
    return lines, secs


def run_script(module: str, args: list[str], env: dict,
               exit_codes: tuple[int, ...] = (0,), cwd: str = REPO) -> tuple[list[str], float]:
    """``start_script``, then ``finish_script``."""
    return finish_script(start_script(module, args, env, cwd), exit_codes)


def committee_line(lines: list[str], n: int, mode: str, tc_heavy: bool) -> re.Match:
    """committee_scale's one result line among ``lines``, parsed and checked
    against what was asked for."""
    found = [m for m in map(COMMITTEE_LINE.fullmatch, lines) if m]
    check(len(found) == 1, f"committee_scale printed {len(found)} result lines at N={n}")
    m = found[0]
    f = (n - 1) // 3
    check((int(m["n"]), int(m["f"]), int(m["q"]), m["mode"], bool(m["tc"]))
          == (n, f, 2 * f + 1, mode, tc_heavy), f"committee_scale's line says {m[0]!r}")
    return m


def result_file_holds(path: str, lines: list[str]) -> None:
    check(os.path.isfile(path), f"no result file {path}")
    with open(path) as f:
        check(f.read() == "".join(line + "\n" for line in lines),
              f"{path} does not hold the printed lines")


def harness_widths(widths: dict, inner: CudaBackend, device, imad_per_s: float,
                   what: str) -> dict:
    """The cached kernels against their plain versions at the widths of
    ``widths`` that no earlier phase held; their rows ({} when none)."""
    new = {w: b for w, b in widths.items() if w not in CHECKED_WIDTHS}
    seen = sorted(set(widths) - set(new))
    print(f"harness {what}: widths (mf, mc) {sorted(widths)}; held earlier in this run: {seen}")
    return width_checks(new, inner, device, imad_per_s, what) if new else {}


def harness_crypto(card: str, device, imad_per_s: float) -> tuple[dict, dict]:
    """18a: ``committee_scale --mode crypto`` at BASELINE configs 3 and 4
    and config 4's view-change regime, each from its command line, then
    ``run_crypto_rounds`` in this process under ``cuda`` with the launches
    counted. Returns (the in-process launches, the kernels' rows at the
    widths no earlier phase held)."""
    env = harness_env(HOTSTUFF_CRYPTO_BACKEND="cuda", HOTSTUFF_CERT_ARENA="0")
    tmp = tempfile.mkdtemp(prefix="phase18a-")
    try:
        for n, tc_heavy in HARNESS_CRYPTO:
            args = ["--mode", "crypto", "--nodes", str(n), "--rounds", str(HARNESS_ROUNDS),
                    "--output", tmp] + (["--tc-heavy"] if tc_heavy else [])
            lines, secs = run_script("committee_scale", args, env)
            m = committee_line(lines, n, "crypto", tc_heavy)
            check((m["backend"], m["transport"]) == ("cuda", "asyncio"),
                  f"committee_scale ran under {m['backend']} on {m['transport']}")
            result_file_holds(os.path.join(tmp, f"committee-crypto{'-tc' if tc_heavy else ''}"
                                                f"-{m['backend']}-{n}.txt"), [m[0]])
            print(f"harness 18a on {card}: committee_scale --mode crypto --nodes {n}"
                  f"{' --tc-heavy' if tc_heavy else ''} --rounds {HARNESS_ROUNDS} "
                  f"(HOTSTUFF_CRYPTO_BACKEND=cuda, HOTSTUFF_CERT_ARENA=0): {m['ms']} ms/round "
                  f"({m['rps']} rounds/s); the result file holds the line; child {secs:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    saved_backend, saved_arena = crypto._BACKEND, os.environ.get("HOTSTUFF_CERT_ARENA")
    os.environ["HOTSTUFF_CERT_ARENA"] = "0"
    crypto.set_backend("cuda")
    backend = crypto.get_backend()
    recorder = VerifyWidths(backend)
    try:
        reset_launches()
        for n, tc_heavy in HARNESS_CRYPTO:
            before = launch_counts()
            ms = committee_scale.run_crypto_rounds(n, HARNESS_ROUNDS, tc_heavy) * 1e3
            got = {k: v - before[k] for k, v in launch_counts().items()}
            verifies = (HARNESS_ROUNDS + 1) * (2 if tc_heavy else 1)
            want = {k: c * verifies for k, c in WARM_QC_ALL.items() if k != "decompress"}
            check({k: got[k] for k in want} == want and got["decompress"] >= verifies,
                  f"18a N={n}{' tc-heavy' if tc_heavy else ''} launched {got} for {verifies} "
                  f"certificate verifies")
            print(f"harness 18a on {card}: run_crypto_rounds({n}, {HARNESS_ROUNDS}, "
                  f"tc_heavy={tc_heavy}) here: {ms:.2f} ms/round; launches "
                  + ", ".join(f"{k} {v}" for k, v in sorted(got.items()) if v))
        launches = launch_counts()
    finally:
        widths, sig_counts = recorder.stop()
        crypto._BACKEND = saved_backend
        if saved_arena is None:
            os.environ.pop("HOTSTUFF_CERT_ARENA", None)
        else:
            os.environ["HOTSTUFF_CERT_ARENA"] = saved_arena
    for name in PHASE8_KERNELS:
        check(launches[name] > 0, f"18a: kernel {name} never launched")
    check(launches["msm_partials"] == 0, f"18a: K4 launched {launches['msm_partials']} times")
    print(f"harness 18a on {card}: CudaBackend calls by signatures {sig_counts}")
    return launches, harness_widths(widths, backend, device, imad_per_s, "18a")


def harness_protocol(card: str) -> tuple[float, int]:
    """18b: ``committee_scale --mode protocol`` at N = 100 under
    ``cuda-batched`` on the native transport, profiled, with its telemetry
    stream. Returns (ms per round, the stream's ``crypto.dispatch.cuda``
    over the measured window)."""
    n, rounds, base = HARNESS_PROTOCOL
    tmp = tempfile.mkdtemp(prefix="phase18b-")
    stream = os.path.join(tmp, f"telemetry-committee-{n}.jsonl")
    try:
        lines, secs = run_script("committee_scale", [
            "--mode", "protocol", "--nodes", str(n), "--rounds", str(rounds), "--profile",
            "--telemetry", stream, "--base-port", str(base), "--output", tmp],
            harness_env(HOTSTUFF_CRYPTO_BACKEND="cuda-batched", HOTSTUFF_NET="native"))
        m = committee_line(lines, n, "protocol", False)
        check((m["backend"], m["transport"]) == ("cuda+superbatch", "native"),
              f"committee_scale ran under {m['backend']} on {m['transport']}")
        at = lines.index(m[0])
        table = lines[at + 1:at + 2]
        for line in lines[at + 2:]:
            if not line.startswith("  "):
                break
            table.append(line)
        check(len(table) > 2 and table[0].startswith("per-stage handler cost"),
              "committee_scale --profile printed no stage table")
        result_file_holds(os.path.join(tmp, f"committee-protocol-{m['backend']}-{n}.txt"),
                          [m[0], *table])
        snaps = logs.read_telemetry_stream(stream)
        check(len(snaps) >= 2, f"{stream} holds {len(snaps)} snapshots")
        moved = (snaps[-1]["counters"].get("crypto.dispatch.cuda", 0)
                 - snaps[0]["counters"].get("crypto.dispatch.cuda", 0))
        check(moved > 0, "18b: crypto.dispatch.cuda did not move in the measured window")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"harness 18b on {card}: committee_scale --mode protocol --nodes {n} --rounds {rounds} "
          f"--profile --telemetry (cuda-batched, HOTSTUFF_NET=native): {m['ms']} ms/round "
          f"({m['rps']} rounds/s), transport={m['transport']}, {len(table) - 2} stages in the "
          f"table, crypto.dispatch.cuda +{moved} over the {len(snaps)} snapshots; child {secs:.1f} s")
    return float(m["ms"]), moved


def harness_digest(card: str) -> tuple[dict, list[str]]:
    """18c: ``digest_bench`` on its default grid in this process, with the
    launches counted, then from its command line for the recommendation.
    Returns (the in-process launches, the command line's lines)."""
    tmp = tempfile.mkdtemp(prefix="phase18c-")
    try:
        buf = io.StringIO()
        reset_launches()
        with contextlib.redirect_stdout(buf):
            digest_bench.main(["--output", tmp])
        launches = launch_counts()
        lines = buf.getvalue().splitlines()
        for line in lines:
            print(f"  | {line}")
        grid = [line for line in lines if line.startswith("digest k=")]
        check(len(grid) == len(DIGEST_DRAINS) * len(DIGEST_SIZES) and all(
            "backend=cuda:" in line for line in grid), f"digest_bench printed {grid}")
        check(lines[-1].startswith("RECOMMEND "), "digest_bench printed no recommendation")
        result_file_holds(os.path.join(tmp, "digest-bench-cuda.txt"), lines)
        want = {**{k: 0 for k in launches}, "sha512": 7 * len(grid)}
        check(launches == want, f"18c launched {launches}, expected {want}")
        print(f"harness 18c on {card}: digest_bench in this process: sha512 launched "
              f"{launches['sha512']} times for {len(grid)} drains, every digest = hashlib")
        cli, secs = run_script("digest_bench", [], harness_env())
        check(cli[-1].startswith("RECOMMEND ")
              and sum(line.startswith("digest k=") for line in cli) == len(grid),
              "digest_bench's command line printed no grid and recommendation")
        print(f"harness 18c on {card}: digest_bench from its command line: {cli[-1]}; "
              f"child {secs:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, cli


def harness_superbatch(card: str, device, imad_per_s: float) -> tuple[dict, dict, list[str]]:
    """18d: ``superbatch_bench`` with its defaults under ``cuda`` in this
    process. Returns (its launches, the kernels' rows at the widths no
    earlier phase held, its lines)."""
    real = CudaBackend.verify_batch
    widths = {}

    def recording(self, msgs, pubs, sigs):
        real(self, msgs, pubs, sigs)
        n = len(msgs)
        widths.setdefault((ov._pad_to_pow2(n), ov._pad_to_pow2(n + 1)),
                          (list(msgs), list(pubs), list(sigs)))

    saved_backend, saved_env = crypto._BACKEND, os.environ.get("HOTSTUFF_CRYPTO_BACKEND")
    os.environ.pop("HOTSTUFF_CRYPTO_BACKEND", None)  # the script's default: cuda
    CudaBackend.verify_batch = recording
    try:
        reset_launches()
        t = time.perf_counter()
        lines = superbatch_bench.main([])
        secs = time.perf_counter() - t
        launches = launch_counts()
        inner = crypto.get_backend()
    finally:
        CudaBackend.verify_batch = real
        crypto._BACKEND = saved_backend
        if saved_env is not None:
            os.environ["HOTSTUFF_CRYPTO_BACKEND"] = saved_env
    check(isinstance(inner, CudaBackend) and lines[0].endswith("inner=cuda"),
          f"superbatch_bench ran on {lines[0]!r}")
    fused = [SUPERBATCH_FUSION.search(line) for line in lines]
    fused = [m for m in fused if m]
    check(len(fused) == 1 and sum(line.startswith("lone-QC ") for line in lines) == 2
          and sum(line.startswith("contended ") for line in lines) == 2,
          f"superbatch_bench printed {lines}")
    requests, calls = int(fused[0]["requests"]), int(fused[0]["calls"])
    # Each backend's lone QC 31 times; the plain backend's QCs twice.
    qcs, lone = 24, 31
    check(requests == lone + 2 * qcs, f"the wrapper took {requests} requests")
    verifies = lone + 2 * qcs + calls
    want = {k: c * verifies for k, c in WARM_QC_ALL.items() if k != "decompress"}
    check({k: launches[k] for k in want} == want and launches["decompress"] >= verifies,
          f"18d launched {launches} for {verifies} CudaBackend calls")
    print(f"harness 18d on {card}: superbatch_bench (defaults, inner cuda) in this process in "
          f"{secs:.1f} s (its pure-Python signing included): fusion {requests} requests in "
          f"{calls} inner calls; launches "
          + ", ".join(f"{k} {v}" for k, v in sorted(launches.items()) if v))
    return launches, harness_widths(widths, inner, device, imad_per_s, "18d"), lines


def stream_dispatch(logs_dir: str) -> dict:
    """Each node stream's last ``crypto.dispatch.cuda`` in ``logs_dir``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(logs_dir, "telemetry-*.jsonl"))):
        snaps = logs.read_telemetry_stream(path)
        out[os.path.basename(path)] = (
            snaps[-1]["counters"].get("crypto.dispatch.cuda", 0) if snaps else 0)
    return out


def harness_local(card: str, config1_tps: float) -> tuple[dict, dict]:
    """18e: ``run_local`` at BASELINE config 1 under ``cuda``, as four node
    and four client processes. Returns (the SUMMARY's figures, each node
    stream's ``crypto.dispatch.cuda``)."""
    nodes, rate, duration, base = HARNESS_LOCAL
    tmp = tempfile.mkdtemp(prefix="phase18e-")
    work = os.path.join(tmp, "bench")
    try:
        lines, secs = run_script("run_local", [
            "--nodes", str(nodes), "--rate", str(rate), "--duration", str(duration),
            "--telemetry", "--base-port", str(base), "--crypto-backend", "cuda",
            "--work-dir", work], harness_env())
        summary = {}
        for line in lines:
            m = SUMMARY_FIGURE.fullmatch(line)
            if m:  # the logs' SUMMARY comes first, the telemetry's after it
                summary.setdefault(m["what"], float(m["value"].replace(",", "")))
        for what in ("Consensus TPS", "Consensus latency", "End-to-end TPS",
                     "End-to-end latency"):
            check(what in summary, f"run_local's SUMMARY holds no {what}")
        check(summary["Consensus TPS"] > 0, "18e committed nothing")
        dispatched = stream_dispatch(os.path.join(work, "logs"))
        check(len(dispatched) == nodes and all(dispatched.values()),
              f"18e: crypto.dispatch.cuda by node stream {dispatched}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"harness 18e on {card}: run_local --nodes {nodes} --rate {rate} --duration {duration} "
          f"--telemetry --crypto-backend cuda (BASELINE config 1, separate processes): consensus "
          f"{summary['Consensus TPS']:.0f} tx/s, latency {summary['Consensus latency']:.0f} ms; "
          f"end-to-end {summary['End-to-end TPS']:.0f} tx/s, latency "
          f"{summary['End-to-end latency']:.0f} ms; 10c in this process {config1_tps:.1f} tx/s; "
          f"crypto.dispatch.cuda by node {sorted(dispatched.values())}; run {secs:.1f} s")
    return summary, dispatched


def harness_phase(card: str, device, imad_per_s: float, config1_tps: float) -> dict:
    """Phase 18: the port's copies of the reference's benchmark scripts, a-e."""
    t = time.perf_counter()
    crypto_launches, crypto_rows = harness_crypto(card, device, imad_per_s)
    protocol_ms, protocol_dispatched = harness_protocol(card)
    digest_launches, _ = harness_digest(card)
    superbatch_launches, superbatch_rows, _ = harness_superbatch(card, device, imad_per_s)
    _, local_dispatched = harness_local(card, config1_tps)
    print(f"harness: phase 18 in {time.perf_counter() - t:.1f} s")
    return {"crypto": crypto_launches, "digest": digest_launches,
            "superbatch": superbatch_launches, "crypto_rows": crypto_rows,
            "superbatch_rows": superbatch_rows,
            "protocol_ms": protocol_ms, "protocol_dispatched": protocol_dispatched,
            "local_dispatched": sum(local_dispatched.values())}


# -- phase 19: the data-plane and robustness harness on the card ----------------


def lifelines_close_or_name(lifeline: dict, what: str) -> None:
    """Every batch of a lifeline report closes the seven edges or names its
    open edge."""
    check("error" not in lifeline and lifeline["batches"] > 0,
          f"{what}: the lifeline report is {lifeline.get('error', lifeline['batches'])}")
    for batch in lifeline["per_batch"]:
        closed = all(v is not None for v in batch["edges_ms"].values())
        check(closed or batch["open_edges"], f"{what}: batch {batch} neither closes nor names")


def robust_dataplane(card: str) -> dict:
    """19a: ``dataplane_sweep`` at phase 11's Conveyor setting as separate
    node processes under the card's default backend, with lifelines."""
    nodes, workers, rate, duration, base = DATAPLANE_SWEEP
    tmp = tempfile.mkdtemp(prefix="phase19a-")
    work, out = os.path.join(tmp, "bench"), os.path.join(tmp, "out")
    try:
        lines, secs = run_script("dataplane_sweep", [
            "--nodes", str(nodes), "--workers", str(workers), "--rates", str(rate),
            "--duration", str(duration), "--dtrace", "--base-port", str(base),
            "--work-dir", work, "--output", out], harness_env())
        tag = f"n{nodes}-w{workers}-512B.json"
        for name in (f"dataplane-sweep-{tag}", f"dataplane-dtrace-{tag}"):
            check(os.path.isfile(os.path.join(out, name)), f"19a: no artifact {name}")
        with open(os.path.join(out, f"dataplane-sweep-{tag}")) as f:
            (row,) = json.load(f)["rows"]
        with open(os.path.join(out, f"dataplane-dtrace-{tag}")) as f:
            lifeline = json.load(f)["lifeline"]
        check("error" not in row and row["e2e_tps"] > 0 and isinstance(row["shed"], int),
              f"19a: the sweep point is {row}")
        lifelines_close_or_name(lifeline, "19a")
        dispatched = stream_dispatch(os.path.join(work, "logs"))
        check(len(dispatched) == nodes and all(dispatched.values()),
              f"19a: crypto.dispatch.cuda by node stream {dispatched}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"robust 19a on {card}: dataplane_sweep --nodes {nodes} --workers {workers} --rates "
          f"{rate} --duration {duration} --dtrace (cuda, separate node processes): e2e "
          f"{row['e2e_tps']} tx/s, latency {row['e2e_latency_ms']} ms; consensus "
          f"{row['consensus_tps']} tx/s, latency {row['consensus_latency_ms']} ms; shed "
          f"{row['shed']}, rate misses {row['rate_misses']}; lifelines: {lifeline['batches']} "
          f"batches, {lifeline['complete']} complete, top cost centers "
          f"{lifeline['top_cost_centers']}; crypto.dispatch.cuda by node "
          f"{sorted(dispatched.values())}; child {secs:.1f} s")
    return {"row": row, "dispatched": sum(dispatched.values())}


def robust_fleet(card: str) -> dict:
    """19b: ``fleet_bench``, open-loop connections with Poisson arrivals."""
    nodes, workers, rate, fleet, bundle, duration, base = FLEET
    tmp = tempfile.mkdtemp(prefix="phase19b-")
    work, out = os.path.join(tmp, "fleet"), os.path.join(tmp, "out")
    try:
        _, secs = run_script("fleet_bench", [
            "--nodes", str(nodes), "--workers", str(workers), "--rate", str(rate),
            "--fleet", str(fleet), "--bundle-txs", str(bundle), "--duration", str(duration),
            "--base-port", str(base), "--work-dir", work, "--output", out], harness_env())
        path = os.path.join(out, f"fleet-n{nodes}-w{workers}-c{fleet}-512B.json")
        check(os.path.isfile(path), f"19b: no artifact {path}")
        with open(path) as f:
            res = json.load(f)["results"]
        check(res["e2e_tps"] > 0 and all(isinstance(res[k], int) for k in (
            "e2e_latency_p99_ms", "e2e_latency_p999_ms", "shed", "churns",
            "ingress_depth_peak")), f"19b: the fleet's results are {res}")
        dispatched = stream_dispatch(os.path.join(work, "logs"))
        check(len(dispatched) == nodes and all(dispatched.values()),
              f"19b: crypto.dispatch.cuda by node stream {dispatched}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"robust 19b on {card}: fleet_bench --nodes {nodes} --workers {workers} --rate {rate} "
          f"--fleet {fleet} --bundle-txs {bundle} --duration {duration} (cuda): e2e "
          f"{res['e2e_tps']} tx/s, latency mean {res['e2e_latency_ms']} / p99 "
          f"{res['e2e_latency_p99_ms']} / p99.9 {res['e2e_latency_p999_ms']} ms; shed "
          f"{res['shed']}, churns {res['churns']}, ingress watermark "
          f"{res['ingress_depth_peak']}; crypto.dispatch.cuda by node "
          f"{sorted(dispatched.values())}; child {secs:.1f} s")
    return {"results": res, "dispatched": sum(dispatched.values())}


def robust_soak(card: str) -> dict:
    """19c: ``soak`` under chaos seed 7 with the tuned watchtower preset,
    run alone. The checker must find the run safe and the log parse no
    panic; the checker's liveness verdict and the SLO engine's are read and
    printed but not required (ROADMAP §3 F11: both packages' committees
    sometimes stall after this schedule's last heal), and the script's
    verdict line and exit code must be the conjunction of the three
    judges."""
    nodes, rate, duration, chaos, base = SOAK
    tmp = tempfile.mkdtemp(prefix="phase19c-")
    work, out = os.path.join(tmp, "soak"), os.path.join(tmp, "out")
    try:
        lines, secs = run_script("soak", [
            "--nodes", str(nodes), "--rate", str(rate), "--duration", str(duration),
            "--chaos-seed", str(chaos), "--watch-config", "preset:tuned-n4",
            "--base-port", str(base), "--work-dir", work, "--output", out], harness_env(),
            exit_codes=(0, 1))
        with open(os.path.join(out, f"soak-slo-n{nodes}-{duration}s-chaos{chaos}.json")) as f:
            verdict = json.load(f)
        chaos_v, slo = verdict["chaos"], verdict["slo"]
        live = chaos_v["liveness"]
        check(chaos_v["safety"]["ok"] and verdict["parse_error"] is None,
              f"19c: the checker {chaos_v['safety']}, the parse {verdict['parse_error']}")
        judges = slo["ok"] and live["recovered"] and verdict["parse_error"] is None
        check(verdict["ok"] == judges and lines[-1] == (
            f"soak verdict: {'PASS' if verdict['ok'] else 'FAIL'}"),
            f"19c: the verdict {verdict['ok']} is not its judges' (slo {slo['ok']}, liveness "
            f"{live['recovered']}): {lines[-1]}")
        alerts = verdict["alerts"]
        check(all(a["config"] == TUNED_N4 for a in alerts["alerts"]),
              f"19c: alerts not from the tuned preset: {[a['config'] for a in alerts['alerts']]}")
        dispatched = stream_dispatch(os.path.join(work, "logs"))
        check(sum(dispatched.values()) > 0, f"19c: crypto.dispatch.cuda by node {dispatched}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    breaches = sorted({(name[10:16], s_["spec"]["name"], s_["violated_fraction"])
                       for name, v in slo["nodes"].items() for s_ in v["slos"] if not s_["ok"]})
    print(f"robust 19c on {card}: soak --nodes {nodes} --rate {rate} --duration {duration} "
          f"--chaos-seed {chaos} --watch-config preset:tuned-n4 (cuda): "
          f"{'PASS' if verdict['ok'] else 'FAIL'}; the checker safe and "
          + ("recovered" if live["recovered"] else "NOT recovered (F11)")
          + f" after the last heal at {live['heal_t']} s (recovery {live['recovery_s']} s, "
          f"post-heal commits {live['post_heal_commits']}, laggards {live['laggards']}), no "
          f"panic in the logs, the SLO engine "
          f"{'ok' if slo['ok'] else 'breached'} over {len(slo['nodes'])} streams"
          + (f" (node, SLO, degraded share of windows, allowed {SOAK_ALLOWED}: {breaches})"
             if breaches else "")
          + f"; the watchtower ({TUNED_N4}) raised {alerts['count']} alerts "
          f"{sorted({a['detector'] for a in alerts['alerts']})}, suspects {alerts['suspects']}; "
          f"telemetry {verdict['telemetry']}; crypto.dispatch.cuda by node "
          f"{sorted(dispatched.values())}; child {secs:.1f} s")
    return {"verdict": verdict, "dispatched": sum(dispatched.values())}


def fault_matrix_start() -> dict:
    """19d's command line, ``fault_matrix`` at N = 20 on both planes under
    ``cuda-batched``, started as a child; ``robust_fault_matrix`` waits
    for it."""
    n, duration, base, _, _ = FAULT_MATRIX
    tmp = tempfile.mkdtemp(prefix="phase19d-")
    return {"tmp": tmp, "child": start_script("fault_matrix", [
        "--nodes", str(n), "--duration", str(duration), "--base-port", str(base),
        "--output", tmp], harness_env(HOTSTUFF_CRYPTO_BACKEND="cuda-batched"))}


def fault_matrix_finish(card: str, started: dict) -> None:
    """Waits for 19d's command line: every verdict on both planes safe and
    recovered."""
    n, duration, _, _, _ = FAULT_MATRIX
    try:
        lines, secs = finish_script(started["child"])
        check(f"fault matrix N={n}: all scenarios safe + recovered" in lines,
              "19d: fault_matrix did not report every scenario safe and recovered")
        with open(os.path.join(started["tmp"], f"fault-matrix-n{n}.json")) as f:
            planes = json.load(f)["planes"]
    finally:
        shutil.rmtree(started["tmp"], ignore_errors=True)
    check(sorted(planes) == ["asyncio", "native"], f"19d: planes {sorted(planes)}")
    for plane, verdicts in planes.items():
        for name, v in verdicts.items():
            check(v["safety"]["ok"] and v["liveness"]["recovered"], f"19d: {plane}/{name} {v}")
        print(f"robust 19d on {card}: fault_matrix --nodes {n} --duration {duration:g} "
              f"(cuda-batched), plane {plane}: " + "; ".join(
                  f"{name} safe, recovered in {v['liveness']['recovery_s']} s, slo "
                  f"{'ok' if v['slo']['ok'] else 'degraded'}" for name, v in verdicts.items()))
    print(f"robust 19d on {card}: fault_matrix's command line, both planes, beside the run "
          f"here, child {secs:.1f} s")


def robust_fault_matrix(card: str, device, imad_per_s: float, started: dict) -> tuple[dict, dict]:
    """19d: ``fault_matrix``'s ``run_plane`` in this process on its
    (asyncio) plane with the launches counted, while the command line's
    child (``fault_matrix_start``) runs both planes: each ``CudaBackend``
    call launches K2 2, K3 2, verdict 1 and one decompression, and every
    other decompression is a key cache insert. Then the child's verdicts,
    then the kernels at the widths no earlier phase held, timed once the
    child has left the card. Returns (the launches, the kernels' rows)."""
    n, _, _, here_s, here = FAULT_MATRIX
    saved_backend = crypto._BACKEND
    telemetry.reset_for_tests()
    crypto.set_backend("cuda-batched")
    inner = crypto.get_backend().inner
    gate, counts, widths = threading.Lock(), {"calls": 0, "inserts": 0}, {}
    real_verify, real_insert = CudaBackend.verify_batch, ov._decompress_packed

    def counted_verify(self, msgs, pubs, sigs):
        with gate:
            out = real_verify(self, msgs, pubs, sigs)
            counts["calls"] += 1
            k = len(msgs)
            widths.setdefault((ov._pad_to_pow2(k), ov._pad_to_pow2(k + 1)),
                              (list(msgs), list(pubs), list(sigs)))
        return out

    def counted_insert(packed):
        counts["inserts"] += 1
        return real_insert(packed)

    CudaBackend.verify_batch, ov._decompress_packed = counted_verify, counted_insert
    t = time.perf_counter()
    try:
        with gate:
            reset_launches()
        verdicts = fault_matrix.run_plane(argparse.Namespace(
            nodes=n, duration=here_s, timeout=1_000, base_port=here, plane="asyncio"))
        with gate:
            launches, calls, inserts = launch_counts(), counts["calls"], counts["inserts"]
    finally:
        CudaBackend.verify_batch, ov._decompress_packed = real_verify, real_insert
        crypto._BACKEND = saved_backend
        telemetry.reset_for_tests()
        telemetry.disable()
        decode_arena.arena()._metrics()  # told that telemetry is off
        cert_arena.reset()
    wall_s = time.perf_counter() - t
    for name, v in verdicts.items():
        check(v["safety"]["ok"] and v["liveness"]["recovered"], f"19d here: {name} {v}")
    want = {**{k: 0 for k in launches}, "decompress": calls + inserts,
            "msm_partials_signed": 2 * calls, "msm_combine": 2 * calls, "verdict": calls}
    check(calls > 0 and launches == want,
          f"19d here: {calls} CudaBackend calls and {inserts} cache inserts launched {launches}")
    print(f"robust 19d on {card}: run_plane here (asyncio, cuda-batched, N={n}, "
          f"{here_s:g} s): " + "; ".join(
        f"{name} safe, recovered in {v['liveness']['recovery_s']} s" for name, v in verdicts.items())
        + f"; {calls} CudaBackend calls, {inserts} key cache inserts; launches "
        + ", ".join(f"{k} {v}" for k, v in sorted(launches.items()) if v) + f"; {wall_s:.1f} s")
    fault_matrix_finish(card, started)
    return launches, harness_widths(widths, inner, device, imad_per_s, "19d")


def robust_phase(card: str, device, imad_per_s: float) -> dict:
    """Phase 19: the port's data-plane and robustness harness, a-d."""
    t = time.perf_counter()
    dataplane = robust_dataplane(card)
    fleet = robust_fleet(card)
    # a and b (throughput figures) and c (a liveness verdict after chaos)
    # run alone; d's command line (one N = 20 committee at a time, one core)
    # runs beside d's run here (another committee, another core).
    soak = robust_soak(card)
    started = fault_matrix_start()
    fm_launches, fm_rows = robust_fault_matrix(card, device, imad_per_s, started)
    print(f"robust: phase 19 in {time.perf_counter() - t:.1f} s")
    return {"fault_matrix": fm_launches, "fault_matrix_rows": fm_rows,
            "dispatch": {"dataplane": dataplane["dispatched"], "fleet": fleet["dispatched"],
                         "soak": soak["dispatched"]}}


# -- phase 20: the measurement tools ---------------------------------------------


def smoke_summary(lines: list[str], what: str) -> dict:
    """The one JSON summary line a smoke gate prints."""
    found = [json.loads(line) for line in lines if SMOKE_SUMMARY.fullmatch(line)]
    check(len(found) == 1, f"{what} printed {len(found)} summary lines")
    return found[0]


def measure_start() -> dict:
    """Phase 20e's two children, started together beside phases 3-5 (neither
    makes a card call): ``dtrace_smoke`` (a real Conveyor worker against
    three acking doubles, its acks checked on the host) and
    ``netplane_frames`` (one edge of each transport, large frames)."""
    repeats, dtrace_base = DTRACE_SMOKE
    sizes, frames, net_base = NETPLANE
    tmp = tempfile.mkdtemp(prefix="phase20e-")
    return {"tmp": tmp, "dtrace": start_script("dtrace_smoke", [
        "--repeats", str(repeats), "--base-port", str(dtrace_base),
        "--work-dir", os.path.join(tmp, "dtrace")], harness_env()),
        "netplane": start_script("netplane_frames", [
            "--sizes", sizes, "--frames", str(frames), "--base-port", str(net_base),
            "--json", os.path.join(tmp, "netplane.json")], harness_env())}


def measure_cpu_phase(card: str, children: dict) -> dict:
    """20e: waits for ``measure_start``'s children. ``dtrace_smoke`` must exit
    0, or 2 (over its overhead budget) with the overhead printed, with no
    problem: lifelines assembled with every data-plane edge, and the
    ``HOTSTUFF_DTRACE=0`` leg streaming no record. ``netplane_frames`` must
    exit 0 with a row for each size on each transport, every frame acked and
    the native rows carrying the engine's counter deltas."""
    tmp = children["tmp"]
    sizes, frames, _ = NETPLANE
    try:
        lines, dtrace_s = finish_script(children["dtrace"], exit_codes=(0, 2))
        dtrace = smoke_summary(lines, "dtrace_smoke")
        check(dtrace["problems"] == [] and dtrace["batches_assembled"] > 0 and dtrace["edges"],
              f"20e: dtrace_smoke's summary {dtrace}")
        lines, net_s = finish_script(children["netplane"])
        with open(os.path.join(tmp, "netplane.json")) as f:
            rows = json.load(f)["rows"]
        want = [(int(size), t) for size in sizes.split(",") for t in ("asyncio", "native")]
        check([(r["size"], r["transport"]) for r in rows] == want
              and all(r["received"] == frames for r in rows)
              and all(r["native_delta"]["frames_rx"] > 0 for r in rows if r["transport"] == "native"),
              f"20e: netplane_frames' rows {[(r['size'], r['transport'], r['received']) for r in rows]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"measure 20e on the host of {card}: dtrace_smoke --repeats {DTRACE_SMOKE[0]}: overhead "
          f"{dtrace['overhead']:+.2%} (legs {dtrace['leg_overheads']}, budget {dtrace['budget']:.0%}), "
          f"{dtrace['off_cpu_ms_per_batch']} ms CPU a batch detached, {dtrace['batches_assembled']} "
          f"lifelines, edges (mean ms) {dtrace['edges']}; child {dtrace_s:.1f} s")
    print(f"measure 20e on the host of {card}: netplane_frames --sizes {sizes} --frames {frames} "
          f"(MB/s): " + ", ".join(f"{r['transport']} {r['size']} B {r['mb_per_s']:.1f}" for r in rows)
          + f"; child {net_s:.1f} s")
    return {"dtrace_overhead": dtrace["overhead"],
            "netplane_mb_per_s": {f"{r['transport']}-{r['size']}": r["mb_per_s"] for r in rows}}


def regress_check(report: dict, lines: list[str], code: int, metric: str, source: str) -> dict:
    """The gate's one check of ``metric``: compared against the committed card
    baseline ``source``, and a verdict line and exit code that say the
    report's ``ok``."""
    check(report["schema"] == "hotstuff-regress-v1" and len(report["checks"]) == 1,
          f"regress printed {report}")
    (chk,) = report["checks"]
    check(chk["metric"] == metric and chk["status"] == "compared"
          and chk["baseline_source"] == source,
          f"regress's check of {metric}: {chk}")
    check(chk["ok"] == (chk["fresh"] <= chk["limit"]) and report["ok"] == chk["ok"]
          and lines[-1] == f"regression gate: {'GREEN' if chk['ok'] else 'RED'}"
          and code == (0 if chk["ok"] else 1), f"regress's verdict {lines[-1]!r}, exit {code}")
    return chk


def regress_start(part: str) -> dict:
    """20a's ``regress`` from its command line under ``cuda-batched``: the
    protocol check alone (the committee at N = 40) or the crypto check
    alone, its artifact in a temporary directory."""
    n, rounds, repeats, base = REGRESS
    args, metric, source = {
        "protocol": (["--nodes", str(n), "--rounds", str(rounds), "--repeats", str(repeats),
                      "--base-port", str(base), "--skip-crypto"],
                     f"protocol_ms_per_round_n{n}", REGRESS_BASELINES[0]),
        "crypto": (["--skip-protocol"], "crypto_cpu_batch_us_per_sig_1343sigs",
                   REGRESS_BASELINES[1]),
    }[part]
    tmp = tempfile.mkdtemp(prefix="phase20a-")
    child = start_script("regress", [*args, "--output", tmp],
                         harness_env(HOTSTUFF_CRYPTO_BACKEND="cuda-batched"))
    return {**child, "part": part, "tmp": tmp, "metric": metric, "source": source,
            "args": " ".join(args)}


def regress_finish(card: str, child: dict) -> dict:
    """Waits for a ``regress_start`` child. Its check must say ``compared``
    against the committed baseline taken on the card's host, and the gate
    must print GREEN or RED as its report says; RED is printed, not
    required (hosts of the same card differ between calls by more than the
    gate's 1.5x)."""
    try:
        lines, secs = finish_script(child, exit_codes=(0, 1))
        with open(os.path.join(child["tmp"], "regress-gate.json")) as f:
            report = json.load(f)
    finally:
        shutil.rmtree(child["tmp"], ignore_errors=True)
    chk = regress_check(report, lines, child["proc"].returncode, child["metric"], child["source"])
    if child["part"] == "protocol":
        check((chk["backend"], chk["transport"]) == ("cuda+superbatch", "asyncio")
              and chk["telemetry"].get("consensus.rounds_advanced", 0) > 0,
              f"20a: the protocol check ran {chk}")
    print(f"measure 20a on {card}: regress {child['args']} (cuda-batched): "
          f"{'GREEN' if chk['ok'] else 'RED'}, {child['part']} fresh {chk['fresh']} against the "
          f"baseline {chk['baseline']} of {chk['baseline_source']} (limit {chk['limit']}): "
          f"ratio {chk['ratio']}; child {secs:.1f} s")
    return chk


def smoke_streams(tmp: str, name: str) -> dict:
    """Each telemetry stream a smoke gate left in its temporary directory
    under ``tmp``: its ``crypto.dispatch.cuda`` from the first snapshot to
    the last."""
    out = {}
    for path in sorted(glob.glob(os.path.join(tmp, f"hotstuff_{name}_*", "*.jsonl"))):
        snaps = logs.read_telemetry_stream(path)
        check(len(snaps) >= 1, f"{path} holds no snapshot")
        out[os.path.basename(path)] = (snaps[-1]["counters"].get("crypto.dispatch.cuda", 0)
                                       - snaps[0]["counters"].get("crypto.dispatch.cuda", 0))
    return out


def smokes_start() -> dict:
    """20b: ``telemetry_smoke``, ``profile_smoke`` and ``watchtower_smoke`` at
    N = 10 with 2 repeats under ``cuda-batched``, started together, each
    leg's streams under one temporary directory (``TMPDIR``)."""
    tmp = tempfile.mkdtemp(prefix="phase20b-")
    env = harness_env(HOTSTUFF_CRYPTO_BACKEND="cuda-batched", TMPDIR=tmp)
    return {"tmp": tmp, "children": {name: start_script(name, [
        "--nodes", str(SMOKE_NODES), "--repeats", str(SMOKE_REPEATS), "--base-port", str(base)],
        env) for name, base in SMOKES}}


def smokes_finish(card: str, started: dict) -> dict:
    """Waits for ``smokes_start``'s children. Each must exit 0, or 2 (over
    its overhead budget, which stays as it is) with its overhead printed,
    and each telemetry stream it wrote must show ``crypto.dispatch.cuda``
    moving."""
    out = {}
    try:
        for name, child in started["children"].items():
            lines, secs = finish_script(child, exit_codes=(0, 2))
            summary = smoke_summary(lines, name)
            problems = summary.get("schema_problems", summary.get("problems"))
            check(problems == [], f"20b: {name}'s problems {problems}")
            moved = smoke_streams(started["tmp"], name)
            check(moved and all(v > 0 for v in moved.values()),
                  f"20b: {name}'s streams' crypto.dispatch.cuda {moved}")
            over = summary["overhead"] > summary["budget"]
            check(child["proc"].returncode == (2 if over else 0),
                  f"20b: {name} exited {child['proc'].returncode} at overhead {summary['overhead']}")
            out[name] = summary
            print(f"measure 20b on {card}: {name} --nodes {SMOKE_NODES} --repeats {SMOKE_REPEATS} "
                  f"(cuda-batched): {'OVER' if over else 'within'} budget {summary['budget']:.0%}: "
                  f"overhead {summary['overhead']:+.2%} ({summary['off_ms_per_round']} ms a round "
                  f"off, {summary['on_ms_per_round']} on); crypto.dispatch.cuda by stream "
                  f"{sorted(moved.values())}; child {secs:.1f} s")
    finally:
        shutil.rmtree(started["tmp"], ignore_errors=True)
    return out


def measure_device(card: str, device, imad_per_s: float) -> tuple[dict, dict, dict]:
    """20c: ``profile_device`` at the bench's width in this process, the
    counts zeroed before and read after: every stage's row printed, and each
    stage's calls (2 warm-ups and 3 rounds of 16) launching the kernels it
    names and no other. Then the root alone against its plain version at
    the profile's width (K4 and K3 were held at it in phase 14). Returns
    (the launches, the stage times, the kernels' rows)."""
    buf, inputs = io.StringIO(), {}
    real_calls = profile_device.stage_calls

    def stage_calls(dev_packed):  # keeps each stage's inputs for the checks below
        inputs.update(real_calls(dev_packed))
        return inputs

    profile_device.stage_calls = stage_calls
    reset_launches()
    try:
        with contextlib.redirect_stdout(buf):
            stages = profile_device.main([str(PROFILE_DEVICE_SIGS)])
        launches = launch_counts()
    finally:
        profile_device.stage_calls = real_calls
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"  | {line}")
    calls = profile_device.WARMUP + profile_device.ROUNDS * profile_device.ITERS
    check(list(stages) == list(PROFILE_STAGES), f"profile_device timed {list(stages)}")
    for name, want in PROFILE_STAGES.items():
        check(any(line.startswith(f"{name:18s} ") and line.endswith(" us/sig") for line in lines),
              f"profile_device printed no row for {name}")
        got = stages[name]["launches"]
        check(got == {k: c * calls for k, c in want.items()},
              f"20c: {name} launched {got} in {calls} calls, expected {want} a call")
    print(f"measure 20c on {card}: profile_device {PROFILE_DEVICE_SIGS} in this process: every "
          f"stage's {calls} calls launched what it names; launches "
          + ", ".join(f"{k} {v}" for k, v in sorted(launches.items()) if v))

    # The root alone at the profile's lanes, a width no earlier phase gives
    # it; phase 14 held K4 and K3 at the same batch's lanes.
    u, v = inputs["sqrt_pow_only"][1]
    m = u.shape[0]
    check(m in CHECKED_UNCACHED, f"20c: no earlier phase held K4 and K3 at m={m}")
    r_k = mk.sqrt_pow(u, v)
    torch.cuda.synchronize()
    t = time.perf_counter()
    r_p = mk.sqrt_pow_plain(u, v)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t) * 1e3
    err = max_abs_err(r_k, r_p)
    check(err == 0, f"20c: sqrt_pow [{m}, 20] differs from its plain version by {err}")
    b, by = bound_ms(MULS_SQRT_POW * m, 3 * m * 80, imad_per_s)
    ms, ev, pr = kernel_ms(lambda: mk.sqrt_pow(u, v), 20, PROFILER_NAMES["sqrt_pow"])
    rows = {"sqrt_pow": dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                             shape=f"u, v [{m}, 20]")}
    print(f"measure 20c: sqrt_pow u, v [{m}, 20] limb-exact against its plain version; "
          f"{ms:.4f} ms (events {ev:.4f}, profiler {pr:.4f}; plain {plain:.1f} ms, bound "
          f"{b:.4f} ms); K4 and K3 at m={m} were held in phase 14")
    return launches, stages, rows


def profilers_start() -> dict:
    """20d: ``sample_profile --by-stage``, ``diag_protocol`` and
    ``profile_protocol`` under ``cuda-batched``, started together, each cut
    from the reference's defaults (10 rounds of 15, 10 s of 60, 5 s of 20)."""
    n, rounds, sample_base = SAMPLE_PROFILE
    dn, seconds, diag_base = DIAG_PROTOCOL
    prof_s, prof_base = PROFILE_PROTOCOL
    env = harness_env(HOTSTUFF_CRYPTO_BACKEND="cuda-batched")
    return {
        "sample_profile": start_script("sample_profile", [
            "--nodes", str(n), "--rounds", str(rounds), "--by-stage", "--base-port",
            str(sample_base)], env),
        "diag_protocol": start_script("diag_protocol", [
            "--nodes", str(dn), "--seconds", str(seconds), "--base-port", str(diag_base)], env),
        "profile_protocol": start_script("profile_protocol", [
            "--seconds", str(prof_s), "--base-port", str(prof_base)], env),
    }


def profilers_finish(card: str, children: dict) -> dict:
    """Waits for ``profilers_start``'s children: each must exit 0 and print
    its table (``diag_protocol`` a progress line each 5 s)."""
    n, rounds, _ = SAMPLE_PROFILE
    dn, seconds, _ = DIAG_PROTOCOL
    prof_s, _ = PROFILE_PROTOCOL
    lines, secs = finish_script(children["sample_profile"])
    head = [line for line in lines if line.startswith(f"committee={n} protocol: ")]
    check(len(head) == 1 and "samples by round-trace stage:" in lines
          and any(line.startswith(" SELF%   CUM%") for line in lines),
          "20d: sample_profile printed no result and tables")
    stage_rows = lines[lines.index("samples by round-trace stage:") + 1:]
    stage_rows = stage_rows[:next(i for i, line in enumerate(stage_rows) if not line.strip())]
    print(f"measure 20d on {card}: sample_profile --nodes {n} --rounds {rounds} --by-stage "
          f"(cuda-batched): {head[0]}; stages {[' '.join(r.split()) for r in stage_rows]}; "
          f"child {secs:.1f} s")
    lines, secs = finish_script(children["diag_protocol"])
    progress = [line for line in lines if line.startswith("t=")]
    # Its committee's commits are printed, not required: a round-1 leader
    # that is not listening yet holds the committee for the 30 s timeout,
    # longer than the cut window (the reference's boot race).
    check(lines[0].startswith(f"spawned {dn} engines") and len(progress) == -(-seconds // 5),
          "20d: diag_protocol printed no progress")
    print(f"measure 20d on {card}: diag_protocol --nodes {dn} --seconds {seconds} "
          f"(cuda-batched): {progress[-1]}; child {secs:.1f} s")
    lines, secs = finish_script(children["profile_protocol"])
    header = [i for i, line in enumerate(lines) if line.split()[:2] == ["ncalls", "tottime"]]
    check(header and any("function calls" in line for line in lines),
          "20d: profile_protocol printed no pstats table")
    total = next(line for line in lines if "function calls" in line).strip()
    print(f"measure 20d on {card}: profile_protocol --seconds {prof_s} (cuda-batched): {total}; "
          f"child {secs:.1f} s")
    return {"sample_profile": head[0]}


def measure_phase(card: str, device, imad_per_s: float) -> dict:
    """Phase 20: the port's measurement tools, a-d (e ran beside phases 3-5).
    The gate's protocol check runs alone (its baseline was taken alone);
    then b, d and the gate's crypto check together (each leg's overhead is
    a min over its own alternating legs, d's figures are diagnostics); then
    c alone, since its stage times are the card's."""
    t = time.perf_counter()
    regress = {"protocol": regress_finish(card, regress_start("protocol"))}
    smokes, crypto_check, profilers = smokes_start(), regress_start("crypto"), profilers_start()
    smoke_summaries = smokes_finish(card, smokes)
    regress["crypto"] = regress_finish(card, crypto_check)
    profilers_finish(card, profilers)
    print(f"measure: phase 20a-b, d in {time.perf_counter() - t:.1f} s")
    device_launches, stages, device_rows = measure_device(card, device, imad_per_s)
    print(f"measure: phase 20 in {time.perf_counter() - t:.1f} s")
    return {"regress": regress, "smokes": smoke_summaries, "profile_device": device_launches,
            "stages": stages, "profile_device_rows": device_rows}


# -- phase 21: the README's quick start through the port's fabfile -------------


def summary_block(lines: list[str]) -> list[str]:
    """The SUMMARY block among a script's printed ``lines``: from the dashes
    above its ``SUMMARY:`` line to the dashes that close it."""
    top = lines.index(" SUMMARY:") - 1
    end = next(i for i in range(top + 3, len(lines)) if lines[i].startswith("-----"))
    return lines[top:end + 1]


def fabfile_phase(card: str) -> dict:
    """Phase 21: ``fabfile local`` as the README gives it for crash faults,
    under ``cuda``, in a temporary working directory (its ``.bench``,
    ``results/`` and ``plots/``), with the node streams in a directory of
    their own; then the host tasks ``fabfile logs`` and ``fabfile
    aggregate`` on what it left. Returns each node stream's
    ``crypto.dispatch.cuda``."""
    nodes, faults, rate, duration = FABFILE_LOCAL
    t = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase21-")
    streams = os.path.join(tmp, "streams")
    os.makedirs(streams)
    try:
        lines, secs = run_script("fabfile", [
            "local", "--nodes", str(nodes), "--faults", str(faults), "--rate", str(rate),
            "--duration", str(duration), "--save"],
            harness_env(HOTSTUFF_CRYPTO_BACKEND="cuda", HOTSTUFF_TELEMETRY_DIR=streams,
                        HOTSTUFF_TELEMETRY_INTERVAL="1", PYTHONPATH=REPO), cwd=tmp)
        block = summary_block(lines)
        check(f" Faults: {faults} nodes" in block and f" Committee size: {nodes} nodes" in block,
              f"21: the SUMMARY does not say {nodes} nodes with {faults} faulty")
        summary = {}
        for line in block:
            m = SUMMARY_FIGURE.fullmatch(line)
            if m:
                summary[m["what"]] = float(m["value"].replace(",", ""))
        check(summary.get("Consensus TPS", 0) > 0, "21 committed nothing")
        dispatched = stream_dispatch(streams)
        check(len(dispatched) == nodes - faults and all(dispatched.values()),
              f"21: crypto.dispatch.cuda by node stream {dispatched} (the faulty node never boots)")
        rounds = []  # each node stream's view changes, for the SUMMARY's latency
        for path in sorted(glob.glob(os.path.join(streams, "telemetry-*.jsonl"))):
            counters = logs.read_telemetry_stream(path)[-1]["counters"]
            rounds.append("/".join(str(counters.get(f"consensus.{name}", 0)) for name in (
                "rounds_advanced", "timeouts_fired", "tcs_formed", "qcs_formed",
                "blocks_committed")))
        saved = os.path.join(tmp, "results", f"bench-{faults}-{nodes}-{rate}-512.txt")
        check(os.path.isfile(saved), f"21 saved no {saved}")
        with open(saved) as f:
            check(summary_block(f.read().splitlines()) == block,
                  f"{saved} does not hold the SUMMARY")
        # The host tasks, together, on the same logs and results.
        host_env = harness_env(PYTHONPATH=REPO)
        logs_child = start_script(
            "fabfile", ["logs", "--dir", ".bench/logs", "--faults", str(faults)], host_env, tmp)
        agg_child = start_script("fabfile", ["aggregate"], host_env, tmp)
        logs_lines, logs_secs = finish_script(logs_child)
        check(summary_block(logs_lines) == block,
              "21: fabfile logs printed another SUMMARY from the same logs")
        agg_lines, agg_secs = finish_script(agg_child)
        series = os.path.join(tmp, "plots", f"agg-l-{faults}-{nodes}-x-512.txt")
        check(f"wrote plots/agg-l-{faults}-{nodes}-x-512.txt" in agg_lines,
              "21: fabfile aggregate wrote no series")
        with open(series) as f:
            rows = f.read().splitlines()
        check(rows[0] == "rate tps tps_std latency latency_std"
              and [row.split()[0] for row in rows[1:]] == [str(rate)],
              f"21: the aggregated series is {rows}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"fabfile 21 on {card}: fabfile local --nodes {nodes} --faults {faults} --rate {rate} "
          f"--duration {duration} --save under cuda (the README's crash-fault quick start, "
          f"{nodes - faults} node and client processes): consensus "
          f"{summary['Consensus TPS']:.0f} tx/s, latency {summary['Consensus latency']:.0f} ms; "
          f"end-to-end {summary['End-to-end TPS']:.0f} tx/s, latency "
          f"{summary['End-to-end latency']:.0f} ms; crypto.dispatch.cuda by node "
          f"{sorted(dispatched.values())}; rounds advanced / timeouts fired / TCs / QCs formed / "
          f"blocks committed by node {sorted(rounds)}; run {secs:.1f} s, fabfile logs "
          f"{logs_secs:.1f} s (the same SUMMARY) beside fabfile aggregate {agg_secs:.1f} s "
          f"({rows[1]})")
    print(f"fabfile: phase 21 in {time.perf_counter() - t:.1f} s")
    return dispatched


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--native-child", type=float, default=None, metavar="PHASE9_MS",
                    help="run phase 16's parts here (set by the phase itself, with "
                         "HOTSTUFF_NET=native), given phase 9's ms per round")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    t_start = time.perf_counter()

    def stamp(what: str) -> None:
        """Where the call's time goes: each phase's end on one clock."""
        print(f"at {time.perf_counter() - t_start:.1f} s: {what} done")

    # 1. toolchain
    card = nvidia_smi("name,power.limit")
    if args.native_child is not None:
        out = native_child(args.seed, card, device, args.native_child)
        print(NATIVE_RESULT + json.dumps(out))
        return 0
    print(card)
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    imad_per_s = sms * INT32_LANES_PER_SM * max_clock_mhz * 1e6
    print(f"torch {torch.__version__} cuda {torch.version.cuda} nvcc {shutil.which('nvcc')} "
          f"capability {cap} SMs {sms} max SM clock {max_clock_mhz:.0f} MHz "
          f"(int32 IMAD peak {imad_per_s / 1e12:.2f} T/s)")

    # 2. build
    t = time.perf_counter()
    kernel_build.load_all()
    print(f"kernel build {time.perf_counter() - t:.1f} s: " + ", ".join(
        f"{name} {secs:.1f} s" for name, (secs, _) in sorted(kernel_build.build_log.items())))
    for name, (regs, stack, spill) in sorted(ptxas_usage().items()):
        print(f"  ptxas {name}: {regs} registers, {stack} B stack, {spill} B spill stores")
    stamp("phase 2")

    # 17, run here, right after the build: engine groups (the committee
    # sharded over spawned worker processes, each verifying on the card) and
    # the sim plane (under the cpu backend). This process launches nothing
    # in it. Its comparison with phases 9 and 16 is printed after phase 16.
    t = time.perf_counter()
    before = launch_counts()
    groups = groups_phase(card)
    check(launch_counts() == before,
          f"phase 17: this process launched kernels: {before} -> {launch_counts()}")
    phase17_s = time.perf_counter() - t
    print(f"phase 17a-b in {phase17_s:.1f} s (the spawns included); this process launched no "
          f"kernel")
    stamp("phase 17a-b")
    # 17c's two children run on the host's other cores beside phases 3-5,
    # which check the kernels on the card from this one thread.
    sim_children = sim_start()
    # 20e's two children (no card call) beside them too.
    measure_children = measure_start()

    # 3. the main path. Phases 3 to 7 run with the process-wide cert arena
    # off, so that a repeated verify of one QC pays the verify it is
    # counted and timed for; phase 8 runs with it on, as a node does.
    os.environ["HOTSTUFF_CERT_ARENA"] = "0"
    t = time.perf_counter()
    keys, committee = make_committee(VALIDATORS, args.seed)
    keygen_s = time.perf_counter() - t
    t = time.perf_counter()
    qcs = [make_qc(keys, committee, r + 1, args.seed) for r in range(ROUNDS)]
    sign_s = time.perf_counter() - t
    n_sigs = len(qcs[0].votes)
    print(f"committee N={VALIDATORS} quorum {committee.quorum_threshold()}: keygen "
          f"{keygen_s:.2f} s, {ROUNDS} QCs of {n_sigs} votes signed in {sign_s:.2f} s "
          f"(signer: {'cryptography' if crypto._HAVE_PYCA else 'pure-Python RFC 8032'})")
    launches, backend, mp = main_path(keys, committee, qcs)
    print(f"main path: {len(qcs)} QCs accepted, tampered QC rejected, QC below quorum "
          f"rejected, uncached QC accepted in {mp['wall_s']:.2f} s; first verifies "
          + ", ".join(f"{x:.1f}" for x in mp["first_ms"])
          + f" ms, uncached {mp['uncached_ms']:.1f} ms; launches {launches}")
    for name in PATH_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched on the main path")

    # 4. small input against the oracle
    oracle_check(device)
    print("oracle: signed and unsigned MSM at m=4 equal the RFC 8032 oracle")

    # 5. kernels against plain versions
    rows, notes, shapes = kernel_checks(qc_batch(qcs[0]), backend, device, imad_per_s,
                                        curve_msm=True)
    print(f"kernels vs plain on the card (limb-exact; MSMs also affine-equal to the plain curve "
          f"MSM), mf={shapes[0]} mc={shapes[1]} uncached m={shapes[2]}:")
    for line in notes:
        print("  " + line)

    stamp("phases 3-5")
    sim = sim_phase(card, sim_children)
    stamp("phase 17c")
    measure_cpu_phase(card, measure_children)
    stamp("phase 20e")

    # 6. warm QC timing
    wall, host, span = qc_timing(qcs, committee, backend, device, reps=3)
    print(f"warm QC.verify (N={VALIDATORS}, {n_sigs} sigs, cached path) on {card}: "
          f"{wall:.2f} ms per QC, {wall * 1e3 / n_sigs:.1f} us/sig; host prep {host:.2f} ms, "
          f"stream span (events; includes host-issue gaps) {span:.2f} ms")
    mk.reset_launches()
    qcs[0].verify(committee)
    warm = dict(mk.LAUNCHES)
    check(warm == WARM_QC_LAUNCHES, f"a warm QC launched {warm}, expected {WARM_QC_LAUNCHES}")
    print(f"warm QC launches: {warm}")

    # 7. where the time goes
    lines, aten_ops, device_ops = profile_qc(qcs[0], committee, reps=3)
    for line in lines:
        print(line)
    check(aten_ops <= MAX_ATEN_OPS and device_ops <= MAX_DEVICE_OPS,
          f"a warm QC ran {aten_ops:.0f} aten ops and {device_ops:.0f} device ops "
          f"(at most {MAX_ATEN_OPS} and {MAX_DEVICE_OPS})")

    stamp("phases 6-7")

    # 8. the node's certificate path
    os.environ["HOTSTUFF_CERT_ARENA"] = "1"
    cert_arena.reset()
    t = time.perf_counter()
    node_launches, nb, fused_batch, batched = node_path(keys, committee, qcs, args.seed)
    cuda = batched.inner
    print(f"node path (cuda-batched, cert arena on) in {time.perf_counter() - t:.2f} s: v2 proposal "
          f"decoded once and re-encoded byte for byte, accepted (decompress 1, K2 2, K3 2, verdict "
          f"1), an arena hit launched nothing; {committee.quorum_threshold()} v2 timeouts of high "
          f"QC rounds 1-3 to a TC, accepted on the card, a flipped TC byte and a TC below quorum "
          f"rejected, a cached high QC launched nothing; the TC and four QCs fused into 2 inner "
          f"calls ({nb['fused_sigs']} signatures in the second), the same four QCs off the v2 wire "
          f"made one call each, a tampered QC among them failed alone, eight copies of a QC "
          f"deduped to one call; launches {node_launches}")
    for name in PHASE8_KERNELS:
        check(node_launches[name] > 0, f"kernel {name} never launched on the node path")
    n_sigs = committee.quorum_threshold()
    print(f"node path numbers on {card}: lone QC through cuda-batched {nb['lone_batched_ms']:.2f} ms, "
          f"direct CudaBackend {nb['lone_direct_ms']:.2f} ms (median of 5 each, in turns)")
    print(f"node path numbers on {card}: four-QC fused flush ({nb['fused_sigs']} signatures) "
          f"{nb['fused_ms']:.2f} ms, {nb['fused_ms'] * 1e3 / nb['fused_sigs']:.2f} us/sig (median "
          f"of 5; its first run in the pooled flush {nb['fused_first_ms']:.2f} ms); the same four "
          f"QCs one by one {nb['four_alone_ms']:.2f} ms (median of 3); the same four QCs as v2 "
          f"copies pooled behind the TC, their 4 inner calls of {n_sigs} {nb['v2_pooled_ms']:.2f} "
          f"ms in all (median of 3)")
    print(f"node path numbers on {card}: TC verify (N={VALIDATORS}, {n_sigs} per-voter digests) "
          f"{nb['tc_ms']:.2f} ms (median of 5); v2 decode of the proposal frame "
          f"{nb['decode_ms']:.3f} ms (median of 20)")
    print(f"node path numbers on {card}: on one QC of {n_sigs} signatures on the card's host, "
          f"CpuBackend(use_rlc=False) (serial, signer: "
          f"{'OpenSSL' if crypto._HAVE_PYCA else 'pure-Python RFC 8032'}) {nb['cpu_qc_ms']:.2f} ms, "
          f"{nb['cpu_qc_ms'] * 1e3 / n_sigs:.1f} us/sig; CpuBackend() (engine native-rlc) "
          f"{nb['cpu_rlc_qc_ms']:.2f} ms, {nb['cpu_rlc_qc_ms'] * 1e3 / n_sigs:.1f} us/sig "
          f"(median of 3 each)")

    # 8d. the kernels at the fused flush's width
    fused_rows, fused_notes, fused_shapes = kernel_checks(fused_batch, cuda, device, imad_per_s,
                                                          uncached=False)
    print(f"kernels vs plain on the card at the fused flush's width (limb-exact), mf={fused_shapes[0]} "
          f"mc={fused_shapes[1]}:")
    for line in fused_notes:
        print("  " + line)

    # 8d, at the widest flush that ``max_sigs`` lets through: twelve QCs and
    # part of a thirteenth (rounds 1 to 13; a QC signs the same votes each
    # time it is made from the seed), mf = pow2(n), mc = pow2(n + 1).
    more = [make_qc(keys, committee, r, args.seed) for r in range(ROUNDS + 1, ROUNDS + 11)]
    wide_batch = tuple(sum(parts, [])[:batched.max_sigs]
                       for parts in zip(*(qc_batch(q) for q in qcs + more)))
    check(len(wide_batch[0]) == batched.max_sigs, "the widest batch is short")
    wide_rows, wide_notes, wide_shapes = kernel_checks(wide_batch, cuda, device, imad_per_s,
                                                       uncached=False)
    check(wide_shapes[:2] == (batched.max_sigs, 2 * batched.max_sigs),
          f"the widest flush ran at mf, mc = {wide_shapes[:2]}")
    wide_ms = median_ms(lambda: cuda.verify_batch(*wide_batch), 3)  # raises on rejection
    print(f"kernels vs plain on the card at the widest flush (limb-exact), {batched.max_sigs} "
          f"signatures, mf={wide_shapes[0]} mc={wide_shapes[1]}; the batch verifies in "
          f"{wide_ms:.2f} ms, {wide_ms * 1e3 / batched.max_sigs:.2f} us/sig (median of 3) on {card}:")
    for line in wide_notes:
        print("  " + line)
    stamp("phase 8")

    # 9. the consensus engine on the card
    committee_launches, committee_rows, profiled_launches, committee_ms = committee_phase(
        args.seed, card, device, imad_per_s)
    stamp("phase 9")

    # 10. the mempool and the node: the digest kernel against its plain
    # version and hashlib, its times, then BASELINE config 1
    t = time.perf_counter()
    for line in digest_checks(args.seed, device, imad_per_s):
        print(line)
    print(f"sha512 checks and times in {time.perf_counter() - t:.1f} s; SASS of sha512_kernel: "
          f"{sass_counts()}")
    config1_launches, sha_row, config1_rows = node_phase(args.seed, card, device, imad_per_s)
    stamp("phase 10")

    # 11. the data plane: four nodes with two workers each at 20,000 tx/s
    conveyor_launches, conveyor_rows = conveyor_phase(args.seed, card, device, imad_per_s)
    stamp("phase 11")

    # 12. replica rejoin: a wiped engine past its peers' floor, a node's warm
    # restart, and the snapshot check at N = 1000
    rejoin_launches, snapshot_launches, rejoin_rows = rejoin_phase(
        args.seed, card, device, imad_per_s, keys, committee)
    stamp("phase 12")

    # 13. the sharded verifier: the tree-combine verdict, then phase 3's QC
    # on meshes of the card
    sharded, tree_row = mesh_phase(qcs, torch.device("cuda", 0), card, imad_per_s)
    sharded_launches_ = sharded["launches"]
    rows["verdict_tree"] = tree_row
    # The sharded runs are the tree kernel's path; phase 3 never reaches it.
    launches["verdict_tree"] = sharded_launches_["verdict_tree"]
    stamp("phase 13")

    # 14. the port's bench: its cached and uncached paths at 1343 signatures,
    # then the kernels at its widths
    bench_cached, bench_uncached, bench_rows = bench_phase(card, device, imad_per_s)
    stamp("phase 14")

    # 15. faultline: the reference's fault scenarios on committees that
    # verify their QCs on the card, the watchtower, and batch_withhold
    faultline_launches = faultline_phase(args.seed, card, device)
    stamp("phase 15")

    # 16. the native plane: phase 9's committee, BASELINE config 4 at
    # N = 1000, config 1 on native stores and a partition scenario, in a
    # child process on the C++ transport
    native, native_ms = native_phase(args.seed, committee_ms)
    stamp("phase 16")

    print(f"phase 17 beside the single-process committees of this call: 17a N=100 in 4 groups "
          f"{groups['17a']['ms_per_round']:.2f} ms per committed round, 16a native "
          f"{native_ms['n100']:.2f} ms, phase 9 asyncio {committee_ms:.2f} ms; 17b N=1000 in 8 "
          f"groups {groups['17b']['ms_per_round']:.2f} ms, 16b native {native_ms['n1000']:.2f} ms, "
          f"17b's first commit {groups['17b']['first_commit_s']:.2f} s after its start; 17c "
          f"{sim['per_min']:.0f} seeds a minute; phase 17a-b "
          f"{phase17_s:.1f} s; launches counted in the groups, 17a "
          f"{groups['17a']['launches']}, 17b {groups['17b']['launches']}")

    # 18. the measurement harness: the port's copies of the reference's
    # benchmark scripts, run through their command lines
    harness = harness_phase(card, device, imad_per_s, sha_row["config1_tx_per_s"])
    stamp("phase 18")

    # 19. the data-plane and robustness harness: the Conveyor sweep, the
    # open-loop fleet, the SLO-gated soak and the fault matrix, through their
    # command lines
    robust = robust_phase(card, device, imad_per_s)
    stamp("phase 19")

    # 20. the measurement tools: the regression gate against the card's
    # baselines, the three smoke gates, the device profile of a QC batch
    # (the root alone's path) and the protocol profilers
    measure = measure_phase(card, device, imad_per_s)
    # profile_device's sqrt_pow_only stage is the root alone's one path.
    launches["sqrt_pow"] = measure["profile_device"]["sqrt_pow"]
    stamp("phase 20")

    # 21. the README's crash-fault quick start through the port's fabfile,
    # then its host tasks on the same logs and results
    fabfile_dispatched = fabfile_phase(card)
    stamp("phase 21")

    kernels = []
    for name in ("decompress", "sqrt_pow", "msm_partials_signed", "msm_combine", "msm_partials",
                 "verdict", "verdict_tree"):
        source, replaces = SOURCES[name]
        row = rows[name]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None, "shape": row["shape"],
            "launches_node_path": node_launches[name],
            "launches_committee": committee_launches[name],
            "launches_committee_profiled": profiled_launches[name],
            "launches_config1": config1_launches[name],
            "launches_conveyor": conveyor_launches[name],
            "launches_rejoin": rejoin_launches[name],
            "launches_rejoin_snapshot": snapshot_launches[name],
            "launches_sharded": sharded_launches_[name],
            "launches_bench_cached": bench_cached[name],
            "launches_bench_uncached": bench_uncached[name],
            "launches_faultline": faultline_launches[name],
            **{f"launches_native_{part}": native[part][name] for part in native},
            "launches_groups_n100": groups["17a"]["launches"][name],
            "launches_groups_n1000": groups["17b"]["launches"][name],
            **{f"launches_harness_{part}": harness[part][name]
               for part in ("crypto", "digest", "superbatch")},
            "launches_harness_fault_matrix": robust["fault_matrix"][name],
            "launches_profile_device": measure["profile_device"][name],
        }
        if name == "verdict":
            entry["harness_dispatch_cuda"] = {"protocol": harness["protocol_dispatched"],
                                              "local": harness["local_dispatched"],
                                              **robust["dispatch"],
                                              "fabfile_local": sum(fabfile_dispatched.values())}
        if name == "verdict_tree":
            entry["sharded_ms_per_qc"] = {str(d): t for d, t in sharded["times"].items()}
            entry["unsharded_ms_per_qc"] = sharded["unsharded"]
        for prefix, extra, row_name in (
                ("fused", fused_rows, name), ("widest", wide_rows, name),
                ("committee", committee_rows, name), ("config1", config1_rows, name),
                ("conveyor", conveyor_rows, name), ("rejoin", rejoin_rows, name),
                ("bench", bench_rows, name), ("bench_uncached", bench_rows, f"{name}_uncached"),
                ("harness_crypto", harness["crypto_rows"], name),
                ("harness_superbatch", harness["superbatch_rows"], name),
                ("harness_fault_matrix", robust["fault_matrix_rows"], name),
                ("profile_device", measure["profile_device_rows"], name)):
            row_x = extra.get(row_name)
            if row_x is not None:
                width = (f"{prefix} flush" if prefix in ("fused", "widest")
                         else prefix.replace("_", " "))
                entry["shape"] += f"; {width} {row_x['shape']}"
                entry.update({f"{prefix}_{key}": row_x[key]
                              for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")})
        kernels.append(entry)
    source, replaces = SOURCES["sha512"]
    kernels.append({
        "name": "sha512", "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches["sha512"], "library_ms": None, **sha_row,
        "launches_node_path": node_launches["sha512"],
        "launches_committee": committee_launches["sha512"],
        "launches_committee_profiled": profiled_launches["sha512"],
        "launches_config1": config1_launches["sha512"],
        "launches_conveyor": conveyor_launches["sha512"],
        "launches_rejoin": rejoin_launches["sha512"],
        "launches_rejoin_snapshot": snapshot_launches["sha512"],
        "launches_sharded": sharded_launches_["sha512"],
        "launches_bench_cached": bench_cached["sha512"],
        "launches_bench_uncached": bench_uncached["sha512"],
        "launches_faultline": faultline_launches["sha512"],
        **{f"launches_native_{part}": native[part]["sha512"] for part in native},
        "launches_groups_n100": groups["17a"]["launches"]["sha512"],
        "launches_groups_n1000": groups["17b"]["launches"]["sha512"],
        **{f"launches_harness_{part}": harness[part]["sha512"]
           for part in ("crypto", "digest", "superbatch")},
        "launches_harness_fault_matrix": robust["fault_matrix"]["sha512"],
        "launches_profile_device": measure["profile_device"]["sha512"],
    })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
