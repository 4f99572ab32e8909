#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`krr_tpu_torch`) on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # every phase; needs one CUDA GPU

Phases, each printing one JSON line (any failure raises and exits non-zero):

1. ``device``  — the card's name, its ``nvidia-smi`` name and power limit.
2. ``build``   — compile every ``krr_tpu_torch/csrc/*.cu`` with nvcc for
   ``sm_90a`` (one nvcc per source, started together); count each kernel's
   global-load opcodes in its SASS (``cuobjdump -sass``, which must sit
   beside ``nvcc``) and require 16-byte loads (``LDG.E.128``) in every
   kernel.
3. ``parity``  — each kernel against its plain PyTorch version on the same
   CUDA tensors, and the plain version on the card against the plain version
   on the CPU: fuzzed ragged rows salted with edge values (±0.0, negatives,
   NaN payloads, subnormals, ±inf, huge values), odd widths, rows longer
   than a block's shared-memory cache, N = 0 and T = 0, and the memory shape
   of the ``simple`` scan; rows aimed at ``row_max``'s scalar head, 16-byte
   body and scalar tail (widths 1–3 past a multiple of 4, counts ending
   inside a ``float4``, a NaN or the peak only in the head or only in the
   tail), at ``bisect_select``'s radix route (the rank on negative NaN
   payloads, digits 0x00/0xff, all-equal rows, count 1, counts past the
   width, whose answer is the NaN 0x7fffffff, q ∈ {0, 50, 99, 100, 120},
   the cache edge inside, at and past the row, read from the built library)
   and its bisection route (``num_iters`` ∈ {0, 1, 17, 30}), and at
   ``topk_select``'s radix select (τ on negative NaN payloads, on zeros and
   subnormals, digit-edge patterns, all-equal rows, counts of K, K − 1 and
   1, state-only rows, the cache edge inside the state, read from the built
   library). ``bisect_select``, ``row_max`` and the top-K rows
   of ``topk_select`` (sorted; K ∈ {128, 1280}, with and without a state)
   are bit-exact; ``digest_hist`` counts and peaks are bit-exact for
   B ∈ {16, 200, 2560} and for a B past shared memory (the global-memory
   bins and tables). Both sketch kernels are also held to their plain
   versions at the ``cli`` scans' shape (10,000 × 1,345). Between the card
   and the CPU the digest's bucket indices may move one bucket where ``log``
   differs by an ulp at a bucket edge: the phase counts those moves and
   checks each is one bucket, at an edge. ``radix_digit_hist`` is bit-exact
   against its plain version in one pass (every (shift, bits) of the
   streamed schedule 11/11/10, every 8-bit digit, and 1- and 12-bit digits;
   prefixes taken from the rows' own keys, bins that already hold counts)
   on the radix rows above, rows on the 11- and 10-bit digit edges, fuzzed
   rows, odd widths, ``w = 1``, N = 0 and T = 0; and over 3 passes (and 4
   of 8 bits), as the streamed radix select, which must give K1's answer on
   the resident window for odd chunk splits. The streamed max, digest and
   top-K builds on the card equal the resident kernels' results. Last,
   ``DeviceObs.fence`` on ``bisect_select``'s output at the headline shape:
   under the null tracer it returns its argument with the kernel still
   running, under a recording tracer it returns once the current stream
   is idle (``torch.cuda.current_stream().query()``).
4. ``digest_proof`` — ``digest_hist`` takes a sample's bucket from tables
   (an edge table and a coarse index), exact where the bucket formula is
   monotone in the bit pattern: for each spec of the parity phase, the
   kernel's formula and its table route on all 2^32 float32 bit patterns
   must agree (mismatches, edges and the most edges in one 2^16-pattern
   range are printed).
5. ``headline`` — the benchmark shape (10,000 × 120,960 float32 for CPU and
   for memory, generated on the card from a seeded generator): CUDA-event
   medians of 5 of ``fleet_exact`` and of each kernel (``digest_hist`` at
   B = 2,560, on these rows and on idle rows of zeros, all in bucket 0;
   ``topk_select`` at K = 1,280), the plain version once, the
   library yardsticks (``torch.kthvalue`` at the same rank, ``torch.amax``,
   ``torch.bincount`` of precomputed bucket indices — histogram only — and
   ``torch.topk``), each kernel's bound, and parity of the kernels with the
   plain versions; also ``row_max_main`` below. ``radix_digit_hist`` per
   launch on one 10,000 × 8,192 chunk of the same values (the first pass,
   where every key counts, the middle and the last, under each row's own
   11- and 22-bit prefix, idle rows of zeros, and the 8-bit schedule's
   four passes), the per-select total, its plain version once, ``torch.bincount`` of precomputed ``row·2^bits +
   digit`` as its yardstick (histogram only) and its bound (the non-zero
   bins counted from the output); and ``digest_hist`` on one such chunk
   beside the build of its bucket tables (once per spec and device).
6. ``e2e``     — scans through ``Runner.run`` with in-memory inventory and
   history sources: 10,000 objects × 3 pods, 40,320 CPU samples and 40,320
   raw memory samples per pod (7 days at 5 s) made with numpy from a seed,
   json output. Three paths, each with every launch count set to 0 just
   before it and read just after: ``simple`` (memory through the stats
   route, one max per pod; ``bisect_select`` and ``row_max`` launched),
   ``tdigest`` (the full raw memory window; ``digest_hist`` and ``row_max``
   launched, ``topk_select`` not, no generic fold) and ``tdigest`` with
   ``exact_upgrade`` (``topk_select`` and ``row_max``; its JSON equals the
   ``simple`` scan's byte for byte). Every scan has 10,000 rows and no
   ``?``. A 256-object re-run on the CPU renders the same JSON for
   ``simple`` and ``exact_upgrade``, and for ``tdigest`` the same memory and
   every CPU value within one bucket of the card's. One more ``simple``
   scan runs with ``profile_dir`` (``torch.profiler``, CPU and CUDA
   activities): its JSON equals the unprofiled scan's, the trace holds
   ``bisect_select_kernel`` and ``row_max_kernel`` as many times as their
   wrappers counted launches, and the traced device busy share (the union
   of kernel, copy and set intervals over the traced window, and over the
   ``Runner.run`` wall) is printed on a ``device_busy`` line.

7. ``stream``  — host streaming (a window past ``--host_stream_mb``) through
   ``Runner.run`` with ``host_stream_mb=1000`` on ``e2e``'s fleet, whose CPU
   window is 4.84 GB as float32 and whose raw memory window is 9.68 GB as
   float64 on the host: 8,192-column chunks from two pinned host buffers
   into two device buffers. ``simple`` (q = 99: the top-K sketch,
   ``topk_select`` once a chunk, ``row_max`` once for the stats-route
   memory), ``tdigest`` (``digest_hist`` and ``row_max`` once a chunk) and
   ``tdigest --exact_upgrade`` (``topk_select`` and ``row_max``) must render
   ``e2e``'s JSON byte for byte; ``simple`` at q = 50 (K past the sketch
   budget: the streamed radix select, ``radix_digit_hist`` once a chunk in
   each of 3 passes) must render a resident q = 50 scan's. Each with every
   count set to 0 just before it: the exact launch counts, no other kernel,
   no generic fold, 10,000 rows and no ``?``, and a peak of allocated device
   memory below 1.5 GB (the resident scans' peaks are printed beside it).
   The legs (pack, host fill, copy wait, fold by CUDA events, stream wall),
   chunks, passes and pinned bytes are printed. Run alone
   (``--phases stream``) it builds the fleet and the resident references
   itself.
8. ``state``   — ``tdigest --state_path`` (the durable digest store) through
   ``Runner.run`` on ``e2e``'s fleet: one resident scan (``digest_hist`` and
   ``row_max`` launched exactly once each, nothing else) and one streamed at
   ``host_stream_mb=1000`` (each once a chunk, 15 chunks), each into a fresh
   state directory with one WAL record appended (at this size the persist
   passes the compaction threshold and folds it into base shards). The
   store's counts, totals and
   peaks and its memory sample counts and peaks must equal, bit for bit,
   what the scan's own ``digest_hist`` and ``row_max`` calls returned
   (captured by wrapping them); reopening the state (manifest and WAL
   replay) must recover the same arrays; the streamed state must equal the
   resident one; each render must carry ``e2e``'s ``tdigest`` memory byte
   for byte and every CPU value within one bucket (the store answers from
   the host query). The legs (digest, fold, quantile, persist), the WAL
   bytes and the reopen time are printed. Run alone (``--phases state``) it
   builds the fleet and the resident reference itself.
9. ``mesh``    — the device mesh (`krr_tpu_torch.parallel`) on the one card:
   each sharded function (percentile, max, digest, top-K) on the headline
   matrix (every 7th row cut to a seeded count, 8 empty) over (4, 1) and
   (2, 2) meshes of ``cuda:0`` four times, and over the distinct cards when
   there are two or more, must equal the resident ``bisect_select``,
   ``row_max``, ``digest_hist`` and ``topk_select`` results bit for bit with
   exact launches (K1 once a row block on (4, 1); ``radix_digit_hist`` once
   a shard in each of 3 passes on (2, 2); the others once a shard); each
   kernel's CUDA-event time per shard is printed beside the resident
   kernel's, and the radix route's per shard and pass. Then ``simple``,
   ``tdigest`` and ``tdigest --exact_upgrade`` through ``Runner.run`` on a
   fleet at ``e2e``'s width and a quarter of its depth (10,080 samples a
   pod) with ``mesh_time_axis=2`` and the strategies' device seam giving
   the card four times, a (2, 2) mesh: each renders the resident scan's
   JSON on that fleet byte for byte with exact launches
   (``radix_digit_hist`` 12 + ``row_max`` 4; ``digest_hist`` 4 +
   ``row_max`` 4; ``topk_select`` 4 + ``row_max`` 4), no generic fold,
   10,000 rows and no ``?``. That fleet and its resident scans are made
   once, before this phase, and serve ``distributed`` too.
10. ``distributed`` — the mesh across processes (`krr_tpu_torch.parallel.
   initialize_distributed`): the parent writes the references (the resident
   kernels on the ``mesh`` phase's matrix, and the resident scans of the
   ``mesh`` phase's quarter-depth fleet) and starts two ranks as child
   processes on a free port, each from the launcher's ``env://`` variables;
   a rank that fails, or a deadline, kills the other and fails the phase.
   On one card both ranks share it and must choose ``gloo``; with two or
   more cards each rank is shown only its own (``CUDA_VISIBLE_DEVICES``)
   and both must choose ``nccl``. Each rank
   runs the five sharded functions on the headline matrix over global
   (2, 1), (1, 2) and (2, 2) meshes (its device once, twice for (2, 2)):
   bit-exact to the resident results with exactly the launches of its own
   shards; it prints each function's wall, its collectives' calls, bytes
   and seconds, the host RSS, and each shard's kernel ms timed with both
   ranks at once and one rank at a time. Then ``simple``, ``tdigest`` and
   ``tdigest --exact_upgrade`` through ``Runner.run`` on the global (2, 1)
   and (1, 2) meshes the strategies resolve from the process group, and
   ``simple`` and ``tdigest`` host-streamed on (2, 1) (``host_stream_mb``
   100: each rank streams its own rows, and the blocks' results, host
   arrays and tensors, are gathered to both): each rank's JSON equals the
   resident scan's byte for byte, with its exact launches, no generic
   fold, 10,000 rows and no ``?``.
11. ``cli``     — the user's entry point, ``krr_tpu_torch``'s click command,
   against the fake apiserver + fake Prometheus of ``tests/fakes/servers.py``
   served from a child process (started when the phase begins, so its
   fixture build overlaps no timed phase): 10,000 Deployments of one
   container and one pod, 1,344 CPU and 1,344 memory samples per pod (14
   days at 15 minutes, quantised as ``bench_e2e.py`` does) and the scan end
   pinned on the fake's sample grid. ``simple``, ``tdigest`` and ``tdigest
   --exact_upgrade true`` run in-process on the card, a cold and a warm run
   each, each with every launch count set to 0 just before it and read just
   after (the same kernels as ``e2e``); every scan has 10,000 rows and no
   ``?``, ``exact_upgrade``'s JSON equals ``simple``'s, and the native
   scanner loaded and streamed the stats queries. One ``python3 -m
   krr_tpu_torch simple`` subprocess with ``--trace --profile --statusz
   --metrics-dump --log-format json`` and one ``--device cpu`` run render
   ``simple``'s JSON byte for byte; the subprocess's stages are children
   of ``compute``, its profile partitions its wall, its statusz counts
   10,000 fetched rows, its dump holds the card's peak memory and a
   compile-cache hit with no miss, and every stderr line is JSON carrying
   the trace's scan id (but the greeting, logged before the scan opens); a ``--device cpu`` run of ``tdigest``
   renders the same memory and every CPU value within one bucket of the
   card's warm ``tdigest`` run. ``tdigest --digest_ingest true`` at
   ``--pipeline-depth 4`` and ``0`` (in the order 4, 0, 0, 4) prints the
   same JSON with no kernel launched (the query is host numpy, as in the
   JAX package) and the pipeline's legs at depth 4. ``tdigest --state_path`` runs twice into one
   sharded state (``digest_hist`` 1 + ``row_max`` 1 each; the second run
   doubles every count and total and appends one WAL record), once with
   ``--store_format legacy`` (the first run's arrays) and once with
   ``--device cpu`` (the first run's arrays, the counts but for one-bucket
   moves of edge samples, which are counted). The warm runs'
   ``Runner.stats`` legs, the strategy's own compute legs (pack, H2D,
   device, finalize; digest, fold, quantile, persist), the store's WAL
   bytes, the fake's CPU seconds, the wire and decoded bytes and the range
   queries' transport phases (summed over queries) are printed.
12. ``serve``   — the serve plane (`krr_tpu_torch.server`) on the ``cli``
   phase's fixture (one child process serves ``cli``, ``serve`` and
   ``push``): ``KrrServer`` on the default device, driven by ``run_once``
   under an injected clock, a fresh sharded state each. With ``--no-hysteresis``: a full 10-day tick at
   ``origin + 10 d`` then a delta tick 2 days later must serve the
   ``/recommendations`` bytes and hold the store arrays of a cold server
   whose first tick covers the 12-day union window, having fetched a delta
   of 2 days less one step; the same ticks on ``device="cpu"`` serve the same
   bytes. With the default flags (hysteresis, sentinel, savings, timeline):
   the tick walls and legs (discover, fetch, fold, compute; the timeline's
   publish seconds, persist seconds and appended WAL bytes), the journal's
   records and bytes, the read path at 10,000 workloads (the pre-rendered
   body, a filtered render on its cache miss and hits, a gzip variant, a
   304 revalidation, ``/metrics`` and ``/statusz``, host-clock ms); then a
   restart on the state directory inside one step: the reopen seconds, a
   first tick that fetches nothing and returns False, the pre-restart
   bytes, ``/healthz`` ``ok``, ``/statusz`` with ``trend`` and ``savings``,
   and one ``/debug/timeline`` record per completed tick. The watch leg:
   a ``discovery_mode="watch"`` server on the same two ``--no-hysteresis``
   ticks serves the relist server's bytes (the seed's and the delta tick's
   discover legs and the fake apiserver's LIST, pod LIST and watch requests
   are printed); a restart on its state directory inside one step
   warm-starts the inventory from the derived
   ``discovery-inventory.json`` with no LIST and serves the same bytes.
   Every kernel's launch count stays 0 across the phase: the serve path and
   watch discovery are host code, as in the JAX package. The default
   server's journal is kept for ``eval``.
13. ``push``    — push ingest (`krr_tpu_torch.ingest`, ``serve --metrics-mode
   push``) on the ``cli`` fixture: a push server (``metrics_mode="push"``,
   ``ingest_port=0``) and a pull control, both ``KrrServer``s on the default
   device with ``--no-hysteresis``, under one injected clock that also pins
   the scheduler's ``time.time()``. A seed tick over 10 days at ``origin +
   10 d`` on both; the fixture's child then remote-writes the next 2 days of
   every series (grid indices 961 … 1,152: 3.84 M samples in bodies of at
   most 2,000 samples, ``tests/fakes/remote_write.py``'s encoding, POSTed in
   order over one kept-alive connection) and both servers tick — the push
   server folds every workload from its plane and audits it against one
   range round; then the last 2 days (indices 1,153 … 1,343) and a steady
   tick. Checked: both push ticks fold 10,000 objects, the audit reads
   10,000 audited and 0 divergent, the steady tick adds 0 to the fake
   Prometheus's request count, every body answers 204 and no sample is
   rejected, the push server's store equals the control's bit for bit and
   its ``/recommendations`` bytes, ETag and epoch equal the control's after
   each tick, and every kernel's launch count stays 0 (push ingest is host
   code, as in the JAX package). Printed: each window's bodies, samples,
   wire bytes, the child's encode and send seconds, the listener's accepted
   samples and bodies a second; each tick's wall and Prometheus requests on
   both servers; the scheduler's ``_ingest_fold`` and the plane's
   ``fold_fleet`` seconds; the samples buffered after the prune; the
   process's RSS growth over the phase.
14. ``federation`` — federation (`krr_tpu_torch.federation`) on its own
   fixture, built in a second child process started beside the ``cli``
   one: 10,000 one-pod Deployments at the ``cli`` shape (1,344 samples at
   15 minutes) in four namespaces of 2,500. On the default device, under one
   injected clock that also pins the scheduler's ``time.time()`` (the
   snapshot's ``published_at``, the ETag's stamp), with ``--no-hysteresis``:
   a control (one single-process ``KrrServer`` over the whole fleet) ticks
   the default 14-day window at ``origin + 12 d``, then the delta to the
   fixture's last sample; an aggregator (``KrrServer`` with
   ``federation_listen`` and a state directory) takes the same two rounds
   from four ``FederatedShard``s, one a namespace (``shard -n ns-k``),
   driven in-process. After round one a ``ReplicaServer`` subscribes; in
   round two one shard's uplink is cut after the aggregator enqueued its
   record and restored before the aggregate tick, so its re-send must be
   discarded as one counted duplicate. Checked: the aggregator's store is
   bit-exact by key to the control's, its ``/recommendations`` bytes, ETag,
   epoch and ``Last-Modified`` equal the control's, the replica serves the
   source's identity and gzip bytes and validators and answers the source's
   ETag with 304, ``fleet-status -f json`` (the port's click command)
   lists the four shards and the replica, and every kernel's launch count
   stays 0 (federation is host code, as in the JAX package). Printed: each
   shard's tick wall split into discover, fetch + fold, encode and send,
   its wire bytes a tick; each aggregate tick's wall, apply and publish
   seconds, persist and applied records; the replica's install latency
   from the broadcast, its read ms (identity, gzip, 304); the phase's wall.
15. ``eval``    — the replay scoreboard through the port's click command
   (``eval --usage``) on the default device: the ``cli`` fixture's usage
   regenerated at its own shape (10,000 workloads × 1,344 samples, the same
   generator and seed) and written with ``ReplayInput.save_npz``, ``simple``
   and ``tdigest`` replayed over 16 ticks (16 distinct ``tick_ends``).
   Launches counted from 0: ``bisect_select`` 16, ``row_max`` 32,
   ``digest_hist`` 16, ``topk_select`` and ``radix_digit_hist`` 0, no
   generic fold. A second run renders the same bytes; a numpy oracle of the
   scoring over the card's replayed series gives the same incidents and
   slacks within rtol 1e-9; ``--device cpu`` gives the same incidents,
   flaps, ticks, ``samples_scored`` and order with slacks within rtol 1e-9
   (the differing bytes are counted). Printed: each strategy's replay wall
   split into batch builds, ``run_batch``, gate and scoring, rows replayed
   per second, the peak allocated device memory, the scoring reduce alone
   by CUDA events, and ``eval --journal`` on the ``serve`` phase's journal
   (10,000 workloads): its wall and rows.
16. ``bench``   — the port's bench in this process, twice. First
   ``bench_torch.main(["--device", "cuda"])`` with ``BENCH_SKIP_E2E`` at its
   default shape (10,000 × 120,960): its parity gates hold ``fleet_exact``
   (K1 + K2) against its plain version, the top-K sketch's p99 (K4) and the
   digest's (K3) against the exact p99 and the digest's peak against
   ``row_max``, on 512 rows of the real matrix on the card; ``bisect_select``,
   ``row_max``, ``digest_hist`` and ``topk_select`` must each have launched
   at least once in this process (counts set to 0 just before). Then
   ``--smoke``, whose two ``bench_e2e_torch.py`` subprocesses drive the
   ``Runner`` legs against the fakes on the card. Both runs must exit 0 with
   ``"parity": "ok"``. The full-shape run leaves out the seventeen
   service-plane and observability legs (``BENCH_SKIP_JOURNAL``, ``_OBS``,
   ``_CHAOS``, ``_EVAL``, ``_DISCOVERY``, ``_INGEST``, ``_FETCHPLAN``,
   ``_WIRE``, ``_FEDERATION``, ``_HA``, ``_FLEETOBS``, ``_READPATH``,
   ``_STORE``); the smoke run drives them at smoke sizes on the card (the
   journal, the traced scan and ``analyze``, ``run_batch`` under
   ``DeviceObs``, the sentinel, the chaos soak, the eval replays, watch
   discovery, push ingest, the fetch plan, the wire shrink, federation, the
   HA ring and its replica, stitched traces and lineage, the read path, the
   durable store and the SIGKILL soak's serve subprocesses; the HA
   replica's read load at 4 × 200 requests, ``BENCH_HA_READS``), and every
   gate of theirs, the wall-clock ones included, must pass. Launches are
   accounted per leg (``kernel_launches_by_leg``): ``obs_device`` exactly
   ``bisect_select`` and ``row_max`` 1 + 2 × ``BENCH_OBS_RUNS`` (7 at smoke
   size), ``eval`` exactly ``bisect_select`` and ``digest_hist`` 2 ×
   ``tick_ends`` and ``row_max`` 4 × (12, 12, 24 at smoke size), every
   other leg 0 of each, and the K1–K5 counts read after the run must equal
   its ``kernel_launches`` (read before the legs) plus the legs' sum.
   Printed: the full-shape run's headline and secondary fields and
   launches, under ``smoke_e2e`` the smoke run's end-to-end fields, under
   ``smoke_service`` its service legs' fields and under ``smoke_obs`` its
   observability legs' (its kernel legs are toy-sized and not kept).

``row_max_main`` — ``row_max`` at the memory shape of the ``simple`` scan,
per wrapper call (host-bound at that size) and per launch replayed from a
CUDA graph (the kernel's device time). Part of ``headline``; run alone
(``--phases row_max_main``, no build phase) it times the ``krr_tpu_torch``
beside the script, so a copy of the script placed in an unpacked older
commit times that commit's kernel the same way.

The last three lines (printed when all fifteen default phases ran) are the
card's ``nvidia-smi`` name and power limit, one
``{"kernels": [...]}`` JSON object (launch counts from the ``cli`` phase's
warm runs; ``radix_digit_hist``'s from the ``stream`` phase's q = 50 scan),
and ``{"ok": true, "device": {...}}``. The script must run as a
file (``python3 chip_smoke.py``): the fixture's child process re-imports it.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import inspect
import json
import os
import statistics
import subprocess
import sys
import time
from decimal import Decimal

#: Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the
#: float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

HEADLINE_ROWS = 10_000
HEADLINE_T = 120_960
E2E_OBJECTS = 10_000
E2E_PODS = 3
E2E_SAMPLES_PER_POD = 40_320
E2E_CPU_CHECK_ROWS = 256
#: The ``cli`` phase's fleet: one pod per Deployment, 14 days at 15 minutes
#: (the JAX package's default window and the reference's workload shape).
CLI_OBJECTS = 10_000
CLI_SAMPLES = 1_344
CLI_STEP_SECONDS = 900.0
#: The tdigest defaults: B = 2,560 buckets of γ = 1.01 above 1e-7, and the
#: top-K width p99 needs over a 120,960-sample row.
DIGEST_BUCKETS = 2560
DIGEST_MIN_VALUE = 1e-7
DIGEST_LOG_GAMMA = 0.009950330853168083  # math.log(1.01)
TOPK_K = 1280
#: The device every phase runs on; only a rehearsal of the script's control
#: flow on a machine without a card sets it to "cpu".
DEVICE = "cuda"

#: The ``stream`` phase: the window past this many MB streams from host.
STREAM_MB = 1000
#: The streamed chunk width (the ``simple`` strategy's, the ``tdigest``
#: default ``chunk_size``).
STREAM_CHUNK = 8192
#: Allocated device memory a streamed scan may reach: two chunk buffers of
#: 328 MB plus the sketch state and temporaries.
STREAM_PEAK_BYTES = 1.5e9

#: Each kernel: what it replaces (a TPU kernel; K5 the jnp count pass of the
#: JAX package's streamed bisection), its source, and the phase and scan
#: path whose launch count the kernels line reports.
KERNELS = {
    "bisect_select": ("krr_tpu/ops/pallas_select.py:61", "krr_tpu_torch/csrc/select.cu", "cli", "simple"),
    "row_max": ("krr_tpu/ops/pallas_select.py:93", "krr_tpu_torch/csrc/select.cu", "cli", "tdigest"),
    "digest_hist": ("krr_tpu/ops/pallas_sketch.py:99", "krr_tpu_torch/csrc/sketch.cu", "cli", "tdigest"),
    "topk_select": ("krr_tpu/ops/pallas_sketch.py:284", "krr_tpu_torch/csrc/sketch.cu", "cli", "tdigest_exact"),
    "radix_digit_hist": ("krr_tpu/ops/selection.py:142", "krr_tpu_torch/csrc/select.cu", "stream", "simple_p50"),
}
#: ``radix_digit_hist``'s (shift, bits) cases in the parity phase: the
#: streamed schedule, the 8-bit digits, and the narrowest and widest digits.
DIGIT_CASES = ((21, 11), (10, 11), (0, 10), (24, 8), (16, 8), (8, 8), (0, 8), (31, 1), (0, 1), (20, 12), (5, 12))
#: The kernels' function names in the built libraries' SASS.
SASS_KERNELS = ("bisect_select_kernel", "row_max_kernel", "digest_hist_kernel", "topk_select_kernel",
                "radix_digit_hist_kernel")


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, message: str) -> None:
    if not ok:
        raise SmokeFailure(message)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound(n: int, t: int, out_per_row: int = 1) -> tuple[float, str]:
    """(ms, "bytes" | "operations"): the least time for one per-row
    reduction over an [n, t] float32 matrix — every sample read once (plus
    the counts and ``out_per_row`` float32 outputs per row) at the HBM rate,
    or at least one operation per sample at the float32 rate, whichever is
    longer."""
    bytes_ms = 1e3 * (4 * n * t + 4 * n + 4 * n * out_per_row) / PEAK_BYTES_PER_S
    ops_ms = 1e3 * n * t / PEAK_F32_OPS_PER_S
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def cuda_ms(torch, fn, warmup: int = 1, runs: int = 5) -> list[float]:
    """Per-run milliseconds of ``fn`` between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def same_bits(torch, a, b) -> bool:
    return a.shape == b.shape and bool(torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32)))


def sorted_rows(torch, a):
    """Rows sorted by their float32 bits: top-K slot order is unspecified."""
    return torch.sort(a.contiguous().view(torch.int32), dim=1).values.view(torch.float32)


def max_abs_err(torch, a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    check(bool(torch.equal(torch.isnan(a), torch.isnan(b))), "NaN positions differ")
    finite = ~torch.isnan(a)
    if not bool(finite.any()):
        return 0.0
    return float((a[finite] - b[finite]).abs().max())


# ------------------------------------------------------------------ phases
def global_loads(cuda_build, report: dict) -> dict:
    """Per kernel, the count of each global-load opcode in its SASS
    (``cuobjdump -sass``): ``LDG.E.128*`` are the 16-byte loads."""
    import re
    from pathlib import Path

    tool = Path(cuda_build.nvcc_path()).parent / "cuobjdump"
    check(tool.exists(), f"no cuobjdump beside nvcc ({tool}): the SASS load check cannot run")
    loads: dict = {}
    for entry in report.values():
        sass = subprocess.run([str(tool), "-sass", entry["path"]], capture_output=True, text=True, timeout=120,
                              check=True).stdout
        kernel = None
        for line in sass.splitlines():
            if "Function :" in line:
                kernel = next((name for name in SASS_KERNELS if name in line), None)
                if kernel:  # a template kernel has one function per instance
                    loads.setdefault(kernel, {})
            elif kernel and (match := re.search(r"\b(LDG\.[A-Z0-9.]+)", line)):
                loads[kernel][match.group(1)] = loads[kernel].get(match.group(1), 0) + 1
    return loads


def phase_build() -> None:
    from krr_tpu_torch.ops import cuda_build

    started = time.perf_counter()
    report = cuda_build.build_all()
    seconds = time.perf_counter() - started
    ptxas = {
        name: [line.strip() for line in entry["log"].splitlines()
               if "registers" in line or "smem" in line or "stack frame" in line]
        for name, entry in report.items()
    }
    loads = global_loads(cuda_build, report)
    for kernel in SASS_KERNELS:
        check(any(op.startswith("LDG.E.128") for op in loads.get(kernel, {})),
              f"{kernel}: no 16-byte global load in its SASS: {loads.get(kernel)}")
    emit("build", seconds=seconds, sources=sorted(report), ptxas=ptxas, sass_global_loads=loads)


def fuzz(np, seed: int, n: int, t: int, special_frac: float = 0.2):
    special = np.array(
        [
            0x00000000, 0x80000000, 0xBFC00000, 0xFF7FFFFF, 0x7F7FFFFF, 0x7F800000, 0xFF800000,
            0x7FC00000, 0x7FFFFFFF, 0xFFC00000, 0x00000001, 0x000F0000, 0x800F0000, 0x00800000,
        ],
        dtype=np.uint32,
    ).view(np.float32)
    rng = np.random.default_rng(seed)
    values = rng.gamma(2.0, 0.05, size=(n, t)).astype(np.float32)
    if seed % 3 == 0:  # heavy ties
        values = (rng.integers(0, 6, size=(n, t)) / 4).astype(np.float32)
    salted = rng.random((n, t)) < special_frac
    values[salted] = rng.choice(special, int(salted.sum()))
    counts = rng.integers(0, t + 1, size=n).astype(np.int32)
    if n > 1:
        counts[0], counts[1] = 0, t
    return values, counts


def row_max_edge_rows(np, seed: int, n: int, t: int):
    """Rows aimed at ``row_max``'s three parts (scalar head to the first
    16-byte boundary, ``float4`` body, scalar tail at the count): widths off
    every multiple of 4 start rows unaligned, counts end at every offset
    inside a ``float4``, and the row's NaN or its largest value sits only in
    the head (position 0) or only in the tail (the last valid position). A
    NaN just past the count must not be read."""
    rng = np.random.default_rng(seed)
    values = rng.gamma(2.0, 0.05, size=(n, t)).astype(np.float32)
    counts = np.maximum(t - np.arange(n) % 9, 0).astype(np.int32)
    counts[n // 2:] = np.minimum(counts[n // 2:], 1 + np.arange(n - n // 2) % 7)
    for r, c in enumerate(counts):
        if c == 0:
            continue
        where = 0 if r % 4 in (0, 1) else c - 1
        values[r, where] = np.float32("nan") if r % 2 else np.float32(1e30)
        if r % 8 == 5:
            values[r, :c] = np.float32(-0.0)
            values[r, where] = np.float32(0.0) if r % 16 == 5 else np.float32(-1e-40)
        if c < t:
            values[r, c] = np.float32("nan")
    return values, counts


#: Edge bit patterns for the radix select of K1 and K4: negative NaN
#: payloads (negative keys, which count toward the rank and give +0.0 when
#: it lands on one), values whose
#: ordered bits are 0 (negatives, ±0.0, subnormals, -inf), and values whose
#: digits are 0x00 or 0xff (+inf, the largest finite, the all-ones NaN,
#: 1.0, the float just below 1.0, the smallest normal).
RADIX_NEGATIVE_KEYS = (0xFFC00000, 0xFFFFFFFF, 0xFF800001)
RADIX_ZERO_KEYS = (0xBF800000, 0x80000000, 0x00000000, 0x00000001, 0x807FFFFF, 0x800F0000, 0xFF800000)
RADIX_DIGIT_EDGES = (0x7F7FFFFF, 0x7FFFFFFF, 0x7F800000, 0x7F800001, 0x3F800000, 0x3F7FFFFF, 0x3F800001,
                    0x3F7FFF00, 0x00800000, 0x00FFFFFF)
#: Bit patterns on the digit edges of the streamed select's 11/11/10
#: schedule: the low 21 or 10 bits all zeros or all ones, in positive
#: values, positive NaN and negative NaN (whose key is negative).
STREAM_DIGIT_EDGES = (0x3F800000, 0x3F9FFFFF, 0x3FA00000, 0x3F8003FF, 0x3F800400, 0x3F7FFC00, 0x3F7FFBFF,
                      0x00800000, 0x00BFFFFF, 0x7F7FFFFF, 0x7F600000, 0x7FFFFC00, 0x7F800400, 0xFFE00000,
                      0xFFDFFFFF, 0xFFC003FF)


def topk_edge_rows(np, seed: int, t: int, k: int):
    """Rows aimed at ``topk_select``'s radix select at width ``t`` and K:
    all-equal rows, rows whose rank lands on negative NaN payloads or on
    keys that read as 0 (τ = +0.0 either way; fractions around and at 1),
    rows of digit-edge patterns only, counts of K, K − 1 and 1 (kv equal to
    the total: rank 0 when there is no state) and an empty chunk (a
    state-only row when a state is given)."""
    rng = np.random.default_rng(seed)
    rows = []

    def mixed(pool, frac):
        row = rng.gamma(2.0, 0.05, size=t).astype(np.float32)
        salted = rng.random(t) < frac
        row[salted] = np.array(pool, dtype=np.uint32).view(np.float32)[rng.integers(0, len(pool), int(salted.sum()))]
        return row

    rows.append((np.full(t, 0.25, dtype=np.float32), t))
    for frac in (0.5, 0.9, 0.99, 1.0):
        rows.append((mixed(RADIX_NEGATIVE_KEYS, frac), t))
        rows.append((mixed(RADIX_ZERO_KEYS, frac), t))
    rows.append((mixed(RADIX_NEGATIVE_KEYS + RADIX_ZERO_KEYS, 1.0), t))
    rows.append((mixed(RADIX_DIGIT_EDGES, 1.0), t))
    rows.append((mixed(RADIX_DIGIT_EDGES, 0.5), t))
    # Exactly total - K negative keys (the rank lands on the smallest
    # non-negative key), and one more (it lands on a negative key).
    for extra in (0, 1):
        row = rng.gamma(2.0, 0.05, size=t).astype(np.float32)
        row[: max(t - k + extra, 0)] = np.array(0xFFC00000, dtype=np.uint32).view(np.float32)
        rows.append((rng.permutation(row), t))
    for count in (k, k - 1, 1, 0):
        rows.append((mixed(RADIX_DIGIT_EDGES + RADIX_NEGATIVE_KEYS, 0.3), min(count, t)))
    values = np.stack([row for row, _ in rows])
    counts = np.array([count for _, count in rows], dtype=np.int32)
    return values, counts


def select_edge_rows(np, seed: int, t: int):
    """Rows aimed at ``bisect_select``'s radix route at width ``t``: all-equal
    rows, rows whose rank lands on negative NaN payloads (answer +0.0) or on
    keys that read as 0, rows on the 8-bit digit edges and on the streamed
    schedule's 11- and 10-bit edges, counts of 1, and counts past the
    width (the rank, taken from the count, may pass the row's keys: answer
    the NaN 0x7fffffff)."""
    rng = np.random.default_rng(seed)

    def mixed(pool, frac):
        row = rng.gamma(2.0, 0.05, size=t).astype(np.float32)
        salted = rng.random(t) < frac
        row[salted] = np.array(pool, dtype=np.uint32).view(np.float32)[rng.integers(0, len(pool), int(salted.sum()))]
        return row

    rows = [(np.full(t, 0.25, dtype=np.float32), t), (np.full(t, -0.0, dtype=np.float32), t)]
    for frac in (0.5, 0.9, 0.99, 1.0):
        rows += [(mixed(RADIX_NEGATIVE_KEYS, frac), t), (mixed(RADIX_ZERO_KEYS, frac), t)]
    rows += [(mixed(RADIX_DIGIT_EDGES, 1.0), t), (mixed(RADIX_DIGIT_EDGES, 0.5), t)]
    rows += [(mixed(STREAM_DIGIT_EDGES, 1.0), t), (mixed(STREAM_DIGIT_EDGES, 0.5), t)]
    rows += [(mixed(RADIX_DIGIT_EDGES + RADIX_NEGATIVE_KEYS, 0.3), 1), (mixed(RADIX_NEGATIVE_KEYS, 1.0), 1)]
    for count in (t + 1, t + 7, 2 * t, 100 * t):
        rows.append((mixed(RADIX_DIGIT_EDGES + RADIX_NEGATIVE_KEYS, 0.2), count))
    values = np.stack([row for row, _ in rows])
    counts = np.array([count for _, count in rows], dtype=np.int32)
    return values, counts


def main_path_memory(torch, np):
    """The memory input ``row_max`` gets in the ``e2e`` scan: one max per pod
    (stats route), packed to one 128-lane row per object; fuzzed, with 0 to
    ``E2E_PODS`` valid samples per row."""
    values, counts = fuzz(np, 99, E2E_OBJECTS, 128)
    counts = np.minimum(counts, E2E_PODS).astype(np.int32)
    return torch.from_numpy(values).to(DEVICE), torch.from_numpy(counts).to(DEVICE)


def phase_parity(torch, np) -> dict:
    from krr_tpu_torch.ops import cuda_select
    from krr_tpu_torch.ops.quantile import masked_max
    from krr_tpu_torch.ops.selection import masked_percentile_bisect, selection_rank

    dev = torch.device(DEVICE)
    shapes = [(300, 1), (257, 31), (301, 1000), (129, 4097), (97, 8191), (64, 8192), (24, 70_001),
              (8, HEADLINE_T), (0, 16), (5, 0)]
    errs = {"bisect_select": 0.0, "row_max": 0.0}
    cases = 0
    for i, (n, t) in enumerate(shapes):
        for special_frac in (0.0, 0.2):
            values, counts = fuzz(np, 100 + i + (50 if special_frac else 0), n, t, special_frac)
            v_cpu, c_cpu = torch.from_numpy(values), torch.from_numpy(counts)
            v, c = v_cpu.to(dev), c_cpu.to(dev)
            for q in (0.0, 50.0, 95.0, 99.0, 100.0, 120.0):
                kernel = cuda_select.masked_percentile_bisect_cuda(v, c, q)
                if n and t:
                    plain = masked_percentile_bisect(v, c, q)
                    check(same_bits(torch, kernel, plain),
                          f"bisect_select != plain at n={n} t={t} q={q} frac={special_frac}")
                    check(same_bits(torch, plain, masked_percentile_bisect(v_cpu, c_cpu, q)),
                          f"plain bisect on the card != on the CPU at n={n} t={t} q={q}")
                    errs["bisect_select"] = max(errs["bisect_select"], max_abs_err(torch, kernel, plain))
                else:
                    check(bool(torch.isnan(kernel).all()) and kernel.shape == (n,),
                          f"degenerate select at n={n} t={t}")
                cases += 1
            kernel = cuda_select.masked_max_cuda(v, c)
            if n and t:
                plain = masked_max(v, c)
                check(same_bits(torch, kernel, plain), f"row_max != plain at n={n} t={t} frac={special_frac}")
                check(same_bits(torch, plain, masked_max(v_cpu, c_cpu)),
                      f"plain max on the card != on the CPU at n={n} t={t}")
                errs["row_max"] = max(errs["row_max"], max_abs_err(torch, kernel, plain))
            else:
                check(bool(torch.isnan(kernel).all()) and kernel.shape == (n,), f"degenerate max at n={n} t={t}")
            cases += 1
    # row_max's head / float4 body / tail split: widths 1, 2 and 3 past a
    # multiple of 4, narrow and past a block's 256 threads × 4.
    for i, t in enumerate((5, 6, 7, 130, 2047, 2049, 2050, 4097, 4098, 4099)):
        values, counts = row_max_edge_rows(np, 400 + i, 72, t)
        v_cpu, c_cpu = torch.from_numpy(values), torch.from_numpy(counts)
        kernel = cuda_select.masked_max_cuda(v_cpu.to(dev), c_cpu.to(dev))
        plain = masked_max(v_cpu.to(dev), c_cpu.to(dev))
        check(same_bits(torch, kernel, plain), f"row_max != plain on the head/tail rows at t={t}")
        check(same_bits(torch, plain, masked_max(v_cpu, c_cpu)), f"plain max on the card != on the CPU at t={t}")
        cases += 1
    v, c = main_path_memory(torch, np)
    kernel = cuda_select.masked_max_cuda(v, c)
    plain = masked_max(v, c)
    check(same_bits(torch, kernel, plain), "row_max != plain at the main path's memory shape")
    errs["row_max"] = max(errs["row_max"], max_abs_err(torch, kernel, plain))
    cases += 1
    for n, tc, tm in [(211, 1000, 130), (64, 4097, 3), (33, 0, 64), (33, 64, 0), (0, 32, 32), (9, 70_001, 128)]:
        cpu, cpu_counts = fuzz(np, 7 + n, n, tc)
        mem, mem_counts = fuzz(np, 8 + n, n, tm)
        args = [torch.from_numpy(a).to(dev) for a in (cpu, cpu_counts, mem, mem_counts)]
        for q in (50.0, 99.0):
            kernel = cuda_select.fleet_exact(*args, q)
            plain = cuda_select.fleet_exact_plain(*args, q)
            check(same_bits(torch, kernel, plain), f"fleet_exact != plain at n={n} tc={tc} tm={tm} q={q}")
            cases += 1
    # bisect_select's radix route: the rows above, with the cache edge just
    # inside, at and past the row; and fewer steps than 31 (the bisection).
    cache_ints = cuda_select.select_cache_ints()
    for t in (300, cache_ints - 3, cache_ints, cache_ints + 5, 70_001):
        values, counts = select_edge_rows(np, 800 + t, t)
        v_cpu, c_cpu = torch.from_numpy(values), torch.from_numpy(counts)
        v, c = v_cpu.to(dev), c_cpu.to(dev)
        for q in (0.0, 50.0, 99.0, 100.0, 120.0):
            kernel = cuda_select.masked_percentile_bisect_cuda(v, c, q)
            plain = masked_percentile_bisect(v, c, q)
            check(same_bits(torch, kernel, plain), f"bisect_select != plain on the radix rows at t={t} q={q}")
            check(same_bits(torch, plain, masked_percentile_bisect(v_cpu, c_cpu, q)),
                  f"plain bisect on the card != on the CPU on the radix rows at t={t} q={q}")
            # Rows whose rank passes their keys (counts past the width; some at q >= 99).
            past = (selection_rank(c_cpu, q) >= c_cpu.clamp(max=t)) & (c_cpu > 0)
            check(bool((kernel.cpu().view(torch.int32)[past] == 0x7FFFFFFF).all()) and (q < 99 or bool(past.any())),
                  f"bisect_select: a rank past the row's keys did not give 0x7fffffff at t={t} q={q}")
            cases += 1
        for num_iters in (0, 1, 17, 30):
            kernel = cuda_select.masked_percentile_bisect_cuda(v, c, 99.0, num_iters=num_iters)
            plain = masked_percentile_bisect(v, c, 99.0, num_iters=num_iters)
            check(same_bits(torch, kernel, plain), f"bisect_select != plain at t={t} num_iters={num_iters}")
            cases += 1
    for num_iters in (0, 1, 17, 30):
        values, counts = fuzz(np, 900 + num_iters, 33, 4097)
        v, c = torch.from_numpy(values).to(dev), torch.from_numpy(counts).to(dev)
        kernel = cuda_select.masked_percentile_bisect_cuda(v, c, 50.0, num_iters=num_iters)
        check(same_bits(torch, kernel, masked_percentile_bisect(v, c, 50.0, num_iters=num_iters)),
              f"bisect_select != plain on fuzzed rows at num_iters={num_iters}")
        cases += 1
    sketch_cases, bucket_moves = sketch_parity(torch, np, errs)
    stream_cases = stream_parity(torch, np, errs)
    torch.cuda.synchronize()
    fence = fence_check(torch)
    emit("parity", cases=cases + sketch_cases + stream_cases, bit_exact=True, max_abs_err=errs,
         digest_bucket_moves_card_vs_cpu=bucket_moves, fence=fence)
    return errs


def fence_check(torch) -> dict:
    """``DeviceObs.fence`` on ``bisect_select``'s output at the headline
    shape: under the null tracer it returns its argument and leaves the
    kernel running (the stream still busy), under a recording tracer it
    returns its argument once the current stream is idle."""
    from krr_tpu_torch.obs.device import NULL_DEVICE_OBS, DeviceObs
    from krr_tpu_torch.obs.metrics import MetricsRegistry
    from krr_tpu_torch.obs.trace import Tracer
    from krr_tpu_torch.ops import cuda_select

    generator = torch.Generator(device=DEVICE).manual_seed(11)
    values = torch.rand((HEADLINE_ROWS, HEADLINE_T), device=DEVICE, generator=generator)
    counts = torch.full((HEADLINE_ROWS,), HEADLINE_T, dtype=torch.int32, device=DEVICE)
    stream = torch.cuda.current_stream()
    out = cuda_select.masked_percentile_bisect_cuda(values, counts, 99.0)
    check(NULL_DEVICE_OBS.fence(out) is out, "fence: the null fence did not return its argument")
    busy_after_null_fence = not stream.query()
    check(busy_after_null_fence, "fence: the stream was idle right after an untraced fence (did it wait?)")
    out = cuda_select.masked_percentile_bisect_cuda(values, counts, 99.0)
    busy_after_launch = not stream.query()
    check(DeviceObs(Tracer(), MetricsRegistry()).fence(out) is out, "fence: it did not return its argument")
    check(stream.query(), "fence: the current stream is still busy after a recording tracer's fence")
    del values
    return {"busy_after_launch": busy_after_launch, "busy_after_null_fence": busy_after_null_fence,
            "idle_after_fence": True}


def stream_parity(torch, np, errs: dict) -> int:
    """``radix_digit_hist`` against its plain version on the card and on the
    CPU, one pass at a time, at every digit of the streamed schedule, every
    8-bit digit and 1- and 12-bit digits; the streamed radix select (3
    passes, and 4 of 8 bits) against K1 on the resident window; and the
    streamed max, digest and top-K builds against the resident kernels, for
    odd chunk splits. Returns the case count."""
    from krr_tpu_torch.ops import cuda_select, cuda_sketch
    from krr_tpu_torch.ops import digest as digest_ops
    from krr_tpu_torch.ops import topk_sketch as topk_ops
    from krr_tpu_torch.ops.quantile import masked_max_from_host
    from krr_tpu_torch.ops.selection import (
        INT32_MIN, RADIX_SHIFTS, STREAM_DIGITS, as_ordered_bits, masked_percentile_bisect_from_host,
    )

    dev = torch.device(DEVICE)
    errs["radix_digit_hist"] = 0.0
    cases = 0
    inputs = [select_edge_rows(np, 1000 + t, t) for t in (1, 3, 300, 4097)]
    inputs += [fuzz(np, 1100 + i, n, t, 0.3) for i, (n, t) in
               enumerate([(300, 1), (257, 31), (129, 4097), (64, 8192), (33, 8191), (0, 16), (5, 0)])]
    for values, counts in inputs:
        n, t = values.shape
        rng = np.random.default_rng(n * 7 + t)
        v_cpu, c_cpu = torch.from_numpy(values), torch.from_numpy(counts)
        v, c = v_cpu.to(dev), c_cpu.to(dev)
        keys = (as_ordered_bits(v_cpu) ^ INT32_MIN) if t else torch.zeros((n, 1), dtype=torch.int32)
        # Each row's prefix from one of its own keys (so keys match), the last row's at random.
        prefixes = keys[torch.arange(n), torch.from_numpy(rng.integers(0, max(t, 1), n))].contiguous()
        if n:
            prefixes[-1] = int(rng.integers(INT32_MIN, 2**31))
        for shift, bits in DIGIT_CASES:
            start = torch.from_numpy(rng.integers(0, 100, (n, 1 << bits)).astype(np.int32))
            kernel = cuda_select.radix_digit_hist(v, c, prefixes.to(dev), start.clone().to(dev), shift, bits)
            plain = cuda_select.radix_digit_hist_plain(v, c, prefixes.to(dev), start.clone().to(dev), shift, bits)
            cpu = cuda_select.radix_digit_hist_plain(v_cpu, c_cpu, prefixes, start, shift, bits)
            check(same_bits(torch, kernel, plain),
                  f"radix_digit_hist != plain at n={n} t={t} shift={shift} bits={bits}")
            check(same_bits(torch, plain, cpu), f"plain digit histogram on the card != on the CPU at n={n} t={t}")
            cases += 1
    # The 3 passes (and the 4 of 8 bits): the streamed radix select against K1 on the resident window.
    eight_bit = tuple((shift, 8) for shift in RADIX_SHIFTS)
    for i, (t, chunk) in enumerate([(300, 7), (4097, 1000), (70_001, 8192), (HEADLINE_T, STREAM_CHUNK)]):
        values, counts = select_edge_rows(np, 1200 + t, t) if t <= 70_001 else fuzz(np, 1200 + i, 16, t, 0.2)
        v, c = torch.from_numpy(values).to(dev), torch.from_numpy(counts).to(dev)
        for q in (0.0, 50.0, 99.0, 100.0, 120.0):
            resident = cuda_select.masked_percentile_bisect_cuda(v, c, q).cpu().numpy()
            for digits in (STREAM_DIGITS, eight_bit) if t == 4097 else (STREAM_DIGITS,):
                streamed = masked_percentile_bisect_from_host(values, counts, q, chunk, device=DEVICE, digits=digits)
                check(np.array_equal(streamed.view(np.int32), resident.view(np.int32)),
                      f"streamed radix select != K1 at t={t} chunk={chunk} q={q} digits={digits}")
                cases += 1
    # The streamed max, digest and top-K builds against the resident kernels.
    values, counts = fuzz(np, 1300, 257, 4097, 0.2)
    memory = np.round(np.random.default_rng(1301).uniform(2e7, 4e9, size=(257, 4097)))
    v, c = torch.from_numpy(values).to(dev), torch.from_numpy(counts).to(dev)
    mem32 = torch.from_numpy(np.ascontiguousarray(memory / 1e6, dtype=np.float32)).to(dev)
    for chunk in (1000, 4096):
        streamed = masked_max_from_host(values, counts, chunk, device=DEVICE)
        check(np.array_equal(streamed.view(np.int32), cuda_select.masked_max_cuda(v, c).cpu().numpy().view(np.int32)),
              f"streamed max != row_max at chunk={chunk}")
        streamed = masked_max_from_host(memory, counts, chunk, scale=1e6, device=DEVICE)
        resident = cuda_select.masked_max_cuda(mem32, c).cpu().numpy()
        check(np.array_equal(streamed.view(np.int32), resident.view(np.int32)),
              f"streamed memory max != row_max at chunk={chunk}")
        spec = digest_ops.DigestSpec()
        streamed_digest = digest_ops.build_from_host(spec, values, counts, chunk, device=DEVICE)
        resident_digest = digest_ops.build_from_packed(spec, v, c)
        check(all(same_bits(torch, a, b) for a, b in zip(streamed_digest, resident_digest)),
              f"streamed digest != digest_hist at chunk={chunk}")
        streamed_topk = topk_ops.build_from_host(values, counts, TOPK_K, chunk, device=DEVICE)
        resident_topk = cuda_sketch.topk_select(v, c, TOPK_K)
        check(same_bits(torch, sorted_rows(torch, streamed_topk.values), sorted_rows(torch, resident_topk)),
              f"streamed top-K != topk_select at chunk={chunk}")
        cases += 4
    return cases


def sketch_parity(torch, np, errs: dict) -> tuple[int, dict]:
    """``digest_hist`` and ``topk_select`` against their plain versions on
    the card (bit-exact), and the plain versions on the card against the
    CPU. Returns the case count and the digest's bucket moves between the
    card and the CPU (``log`` differs by an ulp there)."""
    from krr_tpu_torch.ops import cuda_sketch

    dev = torch.device(DEVICE)
    errs.update({"digest_hist": 0.0, "topk_select": 0.0})
    shapes = [(300, 1), (257, 31), (301, 1000), (129, 4097), (24, 70_001), (8, HEADLINE_T), (0, 16), (5, 0)]
    moves = {"values": 0, "moved": 0}
    cases = 0
    for i, (n, t) in enumerate(shapes):
        for special_frac in (0.0, 0.2):
            values, counts = fuzz(np, 200 + i + (50 if special_frac else 0), n, t, special_frac)
            v_cpu, c_cpu = torch.from_numpy(values), torch.from_numpy(counts)
            v, c = v_cpu.to(dev), c_cpu.to(dev)
            bucket_sets = (16, 200, DIGEST_BUCKETS) + ((60_000,) if n * t <= 1_000_000 else ())
            for buckets in bucket_sets:
                hist, peak = cuda_sketch.digest_hist(v, c, buckets, DIGEST_MIN_VALUE, DIGEST_LOG_GAMMA)
                plain_hist, plain_peak = cuda_sketch.digest_hist_plain(
                    v, c, buckets, DIGEST_MIN_VALUE, DIGEST_LOG_GAMMA
                )
                where = f"n={n} t={t} B={buckets} frac={special_frac}"
                check(same_bits(torch, hist, plain_hist), f"digest_hist counts != plain at {where}")
                check(same_bits(torch, peak, plain_peak), f"digest_hist peak != plain at {where}")
                cpu_hist, cpu_peak = cuda_sketch.digest_hist_plain(
                    v_cpu, c_cpu, buckets, DIGEST_MIN_VALUE, DIGEST_LOG_GAMMA
                )
                check(same_bits(torch, plain_peak, cpu_peak), f"plain digest peak on the card != on the CPU at {where}")
                check(bool(torch.equal(plain_hist.sum(dim=1).cpu(), cpu_hist.sum(dim=1))),
                      f"plain digest totals on the card != on the CPU at {where}")
                cases += 1
            if n and t:
                card_idx = cuda_sketch.bucket_indices(v, DIGEST_BUCKETS, DIGEST_MIN_VALUE, DIGEST_LOG_GAMMA).cpu()
                cpu_idx = cuda_sketch.bucket_indices(v_cpu, DIGEST_BUCKETS, DIGEST_MIN_VALUE, DIGEST_LOG_GAMMA)
                moved = (card_idx != cpu_idx).numpy()
                moves["values"] += int(moved.size)
                moves["moved"] += int(moved.sum())
                if moved.any():
                    check(bool(((card_idx - cpu_idx).abs() <= 1).all()), f"a bucket moved by more than one at n={n} t={t}")
                    q = np.log(values[moved].astype(np.float64) / np.float64(np.float32(DIGEST_MIN_VALUE)))
                    q /= np.float64(np.float32(DIGEST_LOG_GAMMA))
                    ulp = np.spacing(np.abs(q).astype(np.float32)).astype(np.float64)
                    check(bool(np.all(np.abs(q - np.round(q)) <= 4 * ulp)), f"a bucket moved away from an edge at n={n} t={t}")
            for k in (128, TOPK_K):
                for with_state in (False, True):
                    state = state_counts = state_cpu = state_counts_cpu = None
                    if with_state:
                        state_np, state_counts_np = fuzz(np, 300 + i + k, n, k, special_frac)
                        state_cpu, state_counts_cpu = torch.from_numpy(state_np), torch.from_numpy(state_counts_np)
                        state, state_counts = state_cpu.to(dev), state_counts_cpu.to(dev)
                    kernel = cuda_sketch.topk_select(v, c, k, state, state_counts)
                    plain = cuda_sketch.topk_select_plain(v, c, k, state, state_counts)
                    cpu = cuda_sketch.topk_select_plain(v_cpu, c_cpu, k, state_cpu, state_counts_cpu)
                    where = f"n={n} t={t} k={k} state={with_state} frac={special_frac}"
                    check(kernel.shape == (n, k), f"topk_select shape {tuple(kernel.shape)} at {where}")
                    check(same_bits(torch, sorted_rows(torch, kernel), sorted_rows(torch, plain)),
                          f"topk_select != plain (sorted rows) at {where}")
                    check(same_bits(torch, sorted_rows(torch, plain), sorted_rows(torch, cpu)),
                          f"plain top-K on the card != on the CPU at {where}")
                    cases += 1
    # The radix select's hard rows, with the cache edge inside the chunk, past
    # the row, and inside the state.
    for t in (3000, cuda_sketch.topk_cache_ints() - 52, 60_000):
        for k in (128, TOPK_K):
            values, counts = topk_edge_rows(np, 500 + k + t, t, k)
            n = values.shape[0]
            v_cpu, c_cpu = torch.from_numpy(values), torch.from_numpy(counts)
            for with_state in (False, True):
                state_args_cpu = ()
                if with_state:
                    state_np, state_counts_np = fuzz(np, 600 + k + t, n, k)
                    state_counts_np[-1] = k  # the empty-chunk row becomes state-only
                    state_args_cpu = (torch.from_numpy(state_np), torch.from_numpy(state_counts_np))
                args = [a.to(dev) for a in (v_cpu, c_cpu, *state_args_cpu)]
                kernel = cuda_sketch.topk_select(args[0], args[1], k, *args[2:])
                plain = cuda_sketch.topk_select_plain(args[0], args[1], k, *args[2:])
                cpu = cuda_sketch.topk_select_plain(v_cpu, c_cpu, k, *state_args_cpu)
                where = f"edge rows t={t} k={k} state={with_state}"
                check(same_bits(torch, sorted_rows(torch, kernel), sorted_rows(torch, plain)),
                      f"topk_select != plain (sorted rows) at {where}")
                check(same_bits(torch, sorted_rows(torch, plain), sorted_rows(torch, cpu)),
                      f"plain top-K on the card != on the CPU at {where}")
                cases += 1
    # The shape the ``cli`` phase's scans give both kernels: 10,000 rows of
    # a 14-day window at 15 minutes.
    values, counts = fuzz(np, 700, CLI_OBJECTS, CLI_SAMPLES + 1)
    v, c = torch.from_numpy(values).to(dev), torch.from_numpy(counts).to(dev)
    hist, peak = cuda_sketch.digest_hist(v, c, DIGEST_BUCKETS, DIGEST_MIN_VALUE, DIGEST_LOG_GAMMA)
    plain_hist, plain_peak = cuda_sketch.digest_hist_plain(v, c, DIGEST_BUCKETS, DIGEST_MIN_VALUE, DIGEST_LOG_GAMMA)
    check(same_bits(torch, hist, plain_hist) and same_bits(torch, peak, plain_peak),
          "digest_hist != plain at the cli phase's shape")
    kernel = cuda_sketch.topk_select(v, c, TOPK_K)
    plain = cuda_sketch.topk_select_plain(v, c, TOPK_K)
    check(same_bits(torch, sorted_rows(torch, kernel), sorted_rows(torch, plain)),
          "topk_select != plain (sorted rows) at the cli phase's shape")
    return cases + 2, moves


def phase_row_max_main(torch, np) -> dict:
    """``row_max`` at the memory shape the e2e scan gives it: a few
    microseconds, so each timed run holds 100 launches — through the
    wrapper (host-bound at this size) and replayed from a CUDA graph (the
    kernel's device time)."""
    from krr_tpu_torch.ops import cuda_select

    main_v, main_c = main_path_memory(torch, np)
    main_valid = int(main_c.sum())

    def hundred_row_max():
        for _ in range(100):
            cuda_select.masked_max_cuda(main_v, main_c)

    main_times = [ms / 100 for ms in cuda_ms(torch, hundred_row_max)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        hundred_row_max()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        hundred_row_max()
    main_device_times = [ms / 100 for ms in cuda_ms(torch, graph.replay)]
    main_bound = 1e3 * (4 * main_valid + 8 * main_v.shape[0]) / PEAK_BYTES_PER_S
    result = {
        "shape": [E2E_OBJECTS, 128], "valid_samples": main_valid, "ms": statistics.median(main_times),
        "runs_ms": main_times, "graph_replay_ms": statistics.median(main_device_times),
        "graph_replay_runs_ms": main_device_times, "bound_ms": main_bound, "bound_by": "bytes",
    }
    emit("row_max_main", **result)
    return result


def phase_headline(torch, np) -> dict:
    from krr_tpu_torch.ops import cuda_select
    from krr_tpu_torch.ops.quantile import masked_max
    from krr_tpu_torch.ops.selection import masked_percentile_bisect, selection_rank

    dev = torch.device(DEVICE)
    n, t, q = HEADLINE_ROWS, HEADLINE_T, 99.0

    def generate(seed: int):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        values = torch.rand((n, t), generator=gen, device=dev, dtype=torch.float32)
        return values.mul_(values).mul_(0.8).add_(1e-4)  # right-skewed cpu-like values

    cpu = generate(0)
    mem = generate(1)
    counts = torch.full((n,), t, dtype=torch.int32, device=dev)

    fleet_times = cuda_ms(torch, lambda: cuda_select.fleet_exact(cpu, counts, mem, counts, q))
    select_times = cuda_ms(torch, lambda: cuda_select.masked_percentile_bisect_cuda(cpu, counts, q))
    max_times = cuda_ms(torch, lambda: cuda_select.masked_max_cuda(mem, counts))

    kernel_p = cuda_select.masked_percentile_bisect_cuda(cpu, counts, q)
    kernel_m = cuda_select.masked_max_cuda(mem, counts)
    plain_select_ms = cuda_ms(torch, lambda: masked_percentile_bisect(cpu, counts, q), warmup=0, runs=1)[0]
    plain_p = masked_percentile_bisect(cpu, counts, q)
    plain_max_ms = cuda_ms(torch, lambda: masked_max(mem, counts), warmup=0, runs=1)[0]
    plain_m = masked_max(mem, counts)
    check(same_bits(torch, kernel_p, plain_p), "headline bisect_select != plain")
    check(same_bits(torch, kernel_m, plain_m), "headline row_max != plain")
    sample = slice(0, 512)
    check(same_bits(torch, kernel_p[sample], masked_percentile_bisect(cpu[sample].cpu(), counts[sample].cpu(), q)),
          "headline bisect_select != plain on the CPU (512-row sample)")

    k = int(selection_rank(counts[:1], q)[0]) + 1  # kthvalue is 1-based
    kth_times = cuda_ms(torch, lambda: torch.kthvalue(cpu, k, dim=1), warmup=1, runs=3)
    kth = torch.kthvalue(cpu, k, dim=1).values
    amax_times = cuda_ms(torch, lambda: torch.amax(mem, dim=1))

    fleet = cuda_select.fleet_exact(cpu, counts, mem, counts, q)
    check(same_bits(torch, fleet[0], kernel_p) and same_bits(torch, fleet[1], kernel_m),
          "fleet_exact rows != the kernels run alone")
    errs = {"bisect_select": max_abs_err(torch, kernel_p, plain_p), "row_max": max_abs_err(torch, kernel_m, plain_m)}
    kth_equal = bool(torch.equal(kth, kernel_p))
    peak = torch.cuda.max_memory_allocated(dev)
    del cpu, mem, counts, plain_p, plain_m, kernel_p, kernel_m, kth, fleet
    torch.cuda.empty_cache()

    headline = {
        "shape": [n, t],
        "q": q,
        "fleet_exact_ms": statistics.median(fleet_times),
        "fleet_exact_runs_ms": fleet_times,
        "fleet_exact_bound_ms": 2 * bound(n, t)[0],
        "bisect_select": {
            "ms": statistics.median(select_times), "runs_ms": select_times, "plain_ms": plain_select_ms,
            "library_ms": statistics.median(kth_times), "library": "torch.kthvalue",
            "bound_ms": bound(n, t)[0], "bound_by": bound(n, t)[1], "max_abs_err": errs["bisect_select"],
        },
        "row_max": {
            "ms": statistics.median(max_times), "runs_ms": max_times, "plain_ms": plain_max_ms,
            "library_ms": statistics.median(amax_times), "library": "torch.amax",
            "bound_ms": bound(n, t)[0], "bound_by": bound(n, t)[1], "max_abs_err": errs["row_max"],
        },
        "row_max_main_path": phase_row_max_main(torch, np),
        "kthvalue_equals_kernel": kth_equal,
        "peak_device_bytes": peak,
    }
    emit("headline", **headline)
    return headline


def phase_sketch_headline(torch, np) -> dict:
    """``digest_hist`` and ``topk_select`` at the headline shape, on the
    same CPU-like matrix as ``bisect_select``."""
    from krr_tpu_torch.ops import cuda_sketch

    dev = torch.device(DEVICE)
    n, t, b, k = HEADLINE_ROWS, HEADLINE_T, DIGEST_BUCKETS, TOPK_K
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cpu = torch.rand((n, t), generator=gen, device=dev, dtype=torch.float32)
    cpu.mul_(cpu).mul_(0.8).add_(1e-4)
    counts = torch.full((n,), t, dtype=torch.int32, device=dev)

    def digest():
        return cuda_sketch.digest_hist(cpu, counts, b, DIGEST_MIN_VALUE, DIGEST_LOG_GAMMA)

    digest_times = cuda_ms(torch, digest)
    hist, peak = digest()
    plain_digest_ms = cuda_ms(torch, lambda: cuda_sketch.digest_hist_plain(
        cpu, counts, b, DIGEST_MIN_VALUE, DIGEST_LOG_GAMMA), warmup=0, runs=1)[0]
    plain_hist, plain_peak = cuda_sketch.digest_hist_plain(cpu, counts, b, DIGEST_MIN_VALUE, DIGEST_LOG_GAMMA)
    check(same_bits(torch, hist, plain_hist) and same_bits(torch, peak, plain_peak), "headline digest_hist != plain")
    del plain_hist, plain_peak
    # Idle rows (an idle container's CPU reads 0): every sample in bucket 0,
    # so the atomics of a block all hit one bin.
    idle = torch.zeros_like(cpu)
    idle_times = cuda_ms(torch, lambda: cuda_sketch.digest_hist(idle, counts, b, DIGEST_MIN_VALUE, DIGEST_LOG_GAMMA))
    idle_hist, idle_peak = cuda_sketch.digest_hist(idle, counts, b, DIGEST_MIN_VALUE, DIGEST_LOG_GAMMA)
    plain_hist, plain_peak = cuda_sketch.digest_hist_plain(idle, counts, b, DIGEST_MIN_VALUE, DIGEST_LOG_GAMMA)
    check(same_bits(torch, idle_hist, plain_hist) and same_bits(torch, idle_peak, plain_peak),
          "headline digest_hist != plain on the idle rows")
    check(bool((idle_hist[:, 0] == t).all()), "idle rows: not every sample in bucket 0")
    del idle, idle_hist, idle_peak, plain_hist, plain_peak
    torch.cuda.empty_cache()
    # The library yardstick: one bincount over precomputed flat bucket indices
    # (the histogram alone, no bucketize and no peak).
    flat = cuda_sketch.bucket_indices(cpu, b, DIGEST_MIN_VALUE, DIGEST_LOG_GAMMA).to(torch.int64)
    flat += (torch.arange(n, device=dev, dtype=torch.int64) * b)[:, None]
    flat = flat.view(-1)
    bincount_times = cuda_ms(torch, lambda: torch.bincount(flat, minlength=n * b), warmup=1, runs=3)
    check(bool(torch.equal(torch.bincount(flat, minlength=n * b).view(n, b).to(torch.float32), hist)),
          "torch.bincount of the bucket indices != digest_hist counts")
    del flat
    torch.cuda.empty_cache()

    def topk():
        return cuda_sketch.topk_select(cpu, counts, k)

    topk_times = cuda_ms(torch, topk)
    top = topk()
    plain_topk_ms = cuda_ms(torch, lambda: cuda_sketch.topk_select_plain(cpu, counts, k), warmup=0, runs=1)[0]
    plain_top = cuda_sketch.topk_select_plain(cpu, counts, k)
    check(same_bits(torch, sorted_rows(torch, top), sorted_rows(torch, plain_top)), "headline topk_select != plain")
    del plain_top
    library_times = cuda_ms(torch, lambda: torch.topk(cpu, k, dim=1), warmup=1, runs=3)
    library_top = torch.topk(cpu, k, dim=1).values
    check(same_bits(torch, sorted_rows(torch, top), sorted_rows(torch, library_top)),
          "torch.topk != topk_select on the headline rows (positive normal values)")
    del cpu, counts, hist, peak, top, library_top
    torch.cuda.empty_cache()

    digest_bound = bound(n, t, out_per_row=b + 1)
    topk_bound = bound(n, t, out_per_row=k)
    headline = {
        "shape": [n, t],
        "digest_hist": {
            "buckets": b, "ms": statistics.median(digest_times), "runs_ms": digest_times, "plain_ms": plain_digest_ms,
            "library_ms": statistics.median(bincount_times), "library": "torch.bincount (histogram only)",
            "bound_ms": digest_bound[0], "bound_by": digest_bound[1], "max_abs_err": 0.0,
            "idle_rows_ms": statistics.median(idle_times), "idle_rows_runs_ms": idle_times,
            "idle_over_random": statistics.median(idle_times) / statistics.median(digest_times),
        },
        "topk_select": {
            "k": k, "ms": statistics.median(topk_times), "runs_ms": topk_times, "plain_ms": plain_topk_ms,
            "library_ms": statistics.median(library_times), "library": "torch.topk",
            "bound_ms": topk_bound[0], "bound_by": topk_bound[1], "max_abs_err": 0.0,
        },
    }
    emit("headline_sketch", **headline)
    return headline


def phase_stream_headline(torch, np) -> dict:
    """``radix_digit_hist`` on one streamed chunk of the headline rows
    (10,000 × 8,192, CPU-like values generated on the card), at each pass of
    the streamed schedule: the first (every key counts), the middle and the
    last (under each row's own 11- and 22-bit prefix); on idle rows of zeros
    (one hot bin); the 8-bit schedule's four passes; its plain version, ``torch.bincount`` over precomputed ``row·2^bits + digit`` and
    the bound of each pass. Then ``digest_hist`` on such a chunk beside the
    build of its bucket tables, which it does once per spec and device."""
    from krr_tpu_torch.ops import cuda_select, cuda_sketch
    from krr_tpu_torch.ops.selection import INT32_MIN, RADIX_SHIFTS, STREAM_DIGITS, as_ordered_bits

    dev = torch.device(DEVICE)
    n, w = HEADLINE_ROWS, STREAM_CHUNK
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    chunk = torch.rand((n, w), generator=gen, device=dev, dtype=torch.float32)
    chunk.mul_(chunk).mul_(0.8).add_(1e-4)
    idle = torch.zeros_like(chunk)
    eff = torch.full((n,), w, dtype=torch.int32, device=dev)
    keys = as_ordered_bits(chunk) ^ INT32_MIN
    own = keys[:, 0].contiguous()  # each row's first key: the later passes under its prefix
    (first_shift, first_bits), (middle_shift, middle_bits), (last_shift, last_bits) = STREAM_DIGITS
    zero = torch.zeros((n,), dtype=torch.int32, device=dev)
    passes = {  # name: (values, prefixes, shift, bits)
        "first": (chunk, zero, first_shift, first_bits),
        "middle": (chunk, own, middle_shift, middle_bits),
        "last": (chunk, own, last_shift, last_bits),
        "idle": (idle, zero, first_shift, first_bits),
    }

    def bound_of(out) -> tuple[float, str]:
        # Bytes: the chunk, the prefix lengths and prefixes read once, and
        # each non-zero bin read and written once (the bins start at zero).
        nonzero = int(torch.count_nonzero(out))
        digit_bytes = 4 * n * w + 8 * n + 2 * 4 * nonzero
        bytes_ms, ops_ms = 1e3 * digit_bytes / PEAK_BYTES_PER_S, 1e3 * n * w / PEAK_F32_OPS_PER_S
        return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")

    result: dict = {"shape": [n, w], "digits": [list(d) for d in STREAM_DIGITS]}
    for name, (values, prefixes, shift, bits) in passes.items():
        out = torch.zeros((n, 1 << bits), dtype=torch.int32, device=dev)
        times = cuda_ms(torch, lambda: cuda_select.radix_digit_hist(values, eff, prefixes, out, shift, bits), warmup=2)
        out.zero_()
        cuda_select.radix_digit_hist(values, eff, prefixes, out, shift, bits)
        plain = cuda_select.radix_digit_hist_plain(values, eff, prefixes, torch.zeros_like(out), shift, bits)
        check(same_bits(torch, out, plain), f"headline radix_digit_hist != plain ({name} pass)")
        pass_bound, bound_by = bound_of(out)
        result[name] = {"shift": shift, "bits": bits, "ms": statistics.median(times), "runs_ms": times,
                        "nonzero_bins": int(torch.count_nonzero(out)), "bound_ms": pass_bound, "bound_by": bound_by,
                        "bound_share": pass_bound / statistics.median(times)}
        if name == "first":
            first_out, first_bound = out, (pass_bound, bound_by)
            plain_ms = cuda_ms(torch, lambda: cuda_select.radix_digit_hist_plain(
                values, eff, prefixes, torch.zeros_like(out), shift, bits), warmup=0, runs=1)[0]
        del plain
    eight_bit_ms = []
    for shift in RADIX_SHIFTS:  # the 8-bit schedule's passes, under each row's own prefix
        out = torch.zeros((n, 256), dtype=torch.int32, device=dev)
        prefixes = zero if shift == 24 else own
        eight_bit_ms.append(statistics.median(cuda_ms(
            torch, lambda: cuda_select.radix_digit_hist(chunk, eff, prefixes, out, shift, 8), warmup=2)))
    del out
    result["per_select_ms"] = sum(result[name]["ms"] for name in ("first", "middle", "last"))
    result["per_select_8bit_ms"] = sum(eight_bit_ms)
    result["eight_bit_pass_ms"] = eight_bit_ms
    flat = ((keys.to(torch.int64) >> first_shift) & ((1 << first_bits) - 1)) + (
        torch.arange(n, device=dev, dtype=torch.int64) * (1 << first_bits))[:, None]
    flat = flat.view(-1)
    library_times = cuda_ms(torch, lambda: torch.bincount(flat, minlength=n << first_bits), warmup=1, runs=3)
    check(bool(torch.equal(torch.bincount(flat, minlength=n << first_bits).view(n, -1).to(torch.int32), first_out)),
          "torch.bincount of the first digits != radix_digit_hist")
    del flat, keys, idle, first_out
    result.update({
        "ms": result["first"]["ms"], "plain_ms": plain_ms, "library_ms": statistics.median(library_times),
        "library": "torch.bincount (histogram only)", "bound_ms": first_bound[0], "bound_by": first_bound[1],
        "max_abs_err": 0.0,
    })
    digest_times = cuda_ms(torch, lambda: cuda_sketch.digest_hist(chunk, eff, DIGEST_BUCKETS, DIGEST_MIN_VALUE,
                                                                  DIGEST_LOG_GAMMA))
    tables_times = cuda_ms(torch, lambda: cuda_sketch.build_digest_tables(DIGEST_BUCKETS, DIGEST_MIN_VALUE,
                                                                          DIGEST_LOG_GAMMA, dev), runs=11)
    del chunk, eff
    torch.cuda.empty_cache()
    result = {
        "radix_digit_hist": result,
        "digest_chunk": {
            "shape": [n, w], "ms": statistics.median(digest_times), "runs_ms": digest_times,
            "tables_ms": statistics.median(tables_times), "tables_runs_ms": tables_times,
            "tables_over_chunk": statistics.median(tables_times) / statistics.median(digest_times),
        },
    }
    emit("headline_stream", **result)
    return result


def phase_digest_proof() -> dict:
    """The proof behind ``digest_hist``'s bucket tables: for each spec the
    parity phase uses (B ∈ {16, 200, 2,560, 60,000} at min 1e-7, γ = 1.01),
    the kernel's own bucket formula and its table route on all 2^32 float32
    bit patterns, on the card. Zero mismatches, or the phase fails."""
    from krr_tpu_torch.ops import cuda_sketch

    specs = {}
    for buckets in (16, 200, DIGEST_BUCKETS, 60_000):
        started = time.perf_counter()
        report = cuda_sketch.digest_table_check(buckets, DIGEST_MIN_VALUE, DIGEST_LOG_GAMMA)
        report["seconds"] = time.perf_counter() - started
        check(report["mismatches"] == 0, f"digest tables != bucket formula at B={buckets}: {report}")
        specs[str(buckets)] = report
    emit("digest_proof", patterns=2**32, min_value=DIGEST_MIN_VALUE, log_gamma=DIGEST_LOG_GAMMA, specs=specs)
    return specs


class _Inventory:
    def __init__(self, objects):
        self.objects = objects

    async def list_clusters(self):
        return None

    async def list_scannable_objects(self, clusters):
        return list(self.objects)


class _History:
    """Serves per-pod views of two flat sample arrays (CPU and raw memory);
    through the stats route, one memory max per pod instead."""

    def __init__(self, np, cpu_flat, mem_flat, mem_max, resource_type, samples_per_pod: int):
        self.np = np
        self.cpu_flat = cpu_flat
        self.mem_flat = mem_flat
        self.mem_max = mem_max
        self.resource_type = resource_type
        self.samples_per_pod = samples_per_pod

    async def gather_fleet(self, objects, history_seconds, step_seconds, stats_resources=frozenset()):
        cpu_type, mem_type = self.resource_type.CPU, self.resource_type.Memory
        cpu, memory = [], []
        for obj in objects:
            row = int(obj.name.rsplit("-", 1)[1])
            depth = self.samples_per_pod
            first = row * E2E_PODS * depth
            views = [slice(first + p * depth, first + (p + 1) * depth) for p in range(E2E_PODS)]
            cpu.append({pod: self.cpu_flat[views[p]] for p, pod in enumerate(obj.pods)})
            if mem_type in stats_resources:
                memory.append({pod: self.np.asarray([self.mem_max[row, p]]) for p, pod in enumerate(obj.pods)})
            else:
                memory.append({pod: self.mem_flat[views[p]] for p, pod in enumerate(obj.pods)})
        return {cpu_type: cpu, mem_type: memory}


def _reset_counts() -> None:
    from krr_tpu_torch.ops import chunked, cuda_select, cuda_sketch

    cuda_select.reset_launches()
    cuda_sketch.reset_launches()
    chunked.reset_generic_folds()


def _read_counts() -> tuple[dict, dict]:
    from krr_tpu_torch.ops import chunked, cuda_select, cuda_sketch

    return {**cuda_select.LAUNCHES, **cuda_sketch.LAUNCHES}, dict(chunked.GENERIC_FOLDS)


def _bench_run(bench_torch, argv: list, environ) -> dict:
    """``bench_torch.main(argv, environ)`` in this process; its JSON line,
    which must say exit 0 and ``"parity": "ok"``."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_torch.main(argv, environ)
    lines = out.getvalue().strip().splitlines()
    check(bool(lines), f"bench: no JSON line (exit {rc})")
    payload = json.loads(lines[-1])
    check(rc == 0, f"bench exited {rc}: parity {payload.get('parity')}, secondary {payload.get('secondary')}")
    check(payload["parity"] == "ok", f"bench: parity {payload['parity']}")
    return payload


#: The knobs that leave out `bench_torch.py`'s service-plane and
#: observability legs (the ``bench`` phase's full-shape run measures the
#: kernel legs alone).
BENCH_SERVICE_SKIPS = ("BENCH_SKIP_JOURNAL", "BENCH_SKIP_OBS", "BENCH_SKIP_CHAOS", "BENCH_SKIP_EVAL",
                       "BENCH_SKIP_DISCOVERY", "BENCH_SKIP_INGEST", "BENCH_SKIP_FETCHPLAN", "BENCH_SKIP_WIRE",
                       "BENCH_SKIP_FEDERATION", "BENCH_SKIP_HA", "BENCH_SKIP_FLEETOBS", "BENCH_SKIP_READPATH",
                       "BENCH_SKIP_STORE")

#: The prefixes of the service-plane and observability legs' fields in
#: ``secondary``, and the fields of `bench_e2e_torch.py`'s scanner leg that
#: share one.
BENCH_SERVICE_PREFIXES = ("journal_", "chaos_", "eval_", "discovery_", "ingest_", "fetchplan_", "wire_",
                          "federation_", "ha_", "fleet_", "readpath_", "store_")
BENCH_OBS_PREFIXES = ("obs_", "analyze_", "sentinel_", "timeline_")
BENCH_E2E_SCANNER_FIELDS = ("ingest_bytes_per_sample", "ingest_samples_per_sec", "ingest_digest_bytes_per_sec",
                            "ingest_stats_bytes_per_sec", "ingest_raw_bytes_per_sec")

#: The smoke run's HA read load: 4 readers × 200 requests a run instead of
#: the smoke size's 2 × 16 (~10 ms of reads a run, whose RPS moves by a
#: quarter from run to run on the card). The ring, its ticks and the gate
#: stay as they are.
BENCH_HA_READS = {"BENCH_HA_CLIENTS": "4", "BENCH_HA_REQUESTS": "200"}

#: Fields of the service and observability legs that must be 1.0: their
#: exact gates held.
BENCH_SERVICE_EXACT = ("ingest_bitexact", "ingest_zero_range_queries", "federation_bitexact", "ha_bitexact",
                       "ha_failover_zero_lost_epochs", "store_kill_recover_bitexact", "discovery_bitexact",
                       "fetchplan_bitexact", "wire_bitexact", "chaos_recovered_bitexact", "fleet_trace_stitched",
                       "fleet_freshness_monotonic", "fleet_lineage_bitexact")

#: The seventeen legs of the smoke run, as ``kernel_launches_by_leg`` names them.
BENCH_LEGS = ("journal", "obs", "analyze", "obs_device", "sentinel", "chaos", "eval", "discovery", "ingest",
              "fetchplan", "wire", "federation", "ha", "fleet_obs", "readpath", "store", "store_kill")


def bench_smoke_launches(bench_torch) -> dict:
    """The launches each smoke-size leg must make on the card, worked out
    here from the smoke sizes: ``obs_device`` a warm-up and two
    ``simple`` ``run_batch`` calls a run (K1 + K2 each); ``eval`` two
    boards, each replaying ``simple`` (K1 + K2) and ``tdigest`` (K3 + K2)
    once a replay tick; every other leg none."""
    from krr_tpu_torch.eval import tick_ends

    smoke = bench_torch.SMOKE_DEFAULTS
    zero = dict.fromkeys(("bisect_select", "row_max", "topk_select", "digest_hist", "radix_digit_hist"), 0)
    calls = 1 + 2 * max(2, int(smoke["BENCH_OBS_RUNS"]))
    ticks = 2 * len(tick_ends(int(smoke["BENCH_EVAL_SAMPLES"]), int(smoke["BENCH_EVAL_TICKS"])))
    expected = {leg: dict(zero) for leg in BENCH_LEGS}
    expected["obs_device"].update(bisect_select=calls, row_max=calls)
    expected["eval"].update(bisect_select=ticks, row_max=2 * ticks, digest_hist=ticks)
    return expected


def phase_bench() -> dict:
    """`bench_torch.main` on ``DEVICE`` in this process, twice: its kernel
    legs at the bench's own headline shape (``BENCH_SKIP_E2E`` and the
    other legs' skips), launches counted from 0, then ``--smoke`` for its
    two end-to-end subprocesses and its seventeen service-plane and
    observability legs, whose launches are accounted per leg."""
    import bench_torch

    _reset_counts()
    payload = _bench_run(bench_torch, ["--device", DEVICE],
                         {"BENCH_SKIP_E2E": "1", **{key: "1" for key in BENCH_SERVICE_SKIPS}})
    launches, _generic = _read_counts()
    check(all(launches[name] >= 1 for name in bench_torch.KERNELS), f"bench: a kernel leg did not launch: {launches}")
    report = {key: value for key, value in payload.items() if key != "secondary"}
    report.update(launches=launches, secondary=payload["secondary"])
    # The smoke run's kernel legs are toy-sized: only its end-to-end,
    # service and observability numbers are kept, under their own keys.
    _reset_counts()
    smoke = _bench_run(bench_torch, ["--smoke", "--device", DEVICE], {**os.environ, **BENCH_HA_READS})
    after, _generic = _read_counts()
    secondary = smoke["secondary"]
    e2e = {key: value for key, value in secondary.items() if key.startswith(("e2e_", "fleet_e2e_"))}
    check(e2e.get("e2e_objects_per_sec", 0) > 0 and e2e.get("fleet_e2e_objects_per_sec", 0) > 0,
          f"bench: the end-to-end legs delivered no rate: {secondary}")
    report["smoke_e2e"] = e2e
    # Per leg: exactly the launches worked out here (none but in
    # ``obs_device`` and ``eval``; the plain versions on a CPU rehearsal
    # count none). ``kernel_launches`` is read just after the kernel legs:
    # the counts after the run are it plus every leg's.
    by_leg = secondary["kernel_launches_by_leg"]
    expected = bench_smoke_launches(bench_torch)
    if DEVICE != "cuda":
        expected = {leg: dict.fromkeys(counts, 0) for leg, counts in expected.items()}
    check(by_leg == expected, f"bench: launches by leg {by_leg}, expected {expected}")
    summed = {name: secondary["kernel_launches"][name] + sum(leg[name] for leg in by_leg.values()) for name in after}
    check(after == summed, f"bench: launches after the smoke run {after}, kernel legs and legs {summed}")
    service = {key: value for key, value in secondary.items()
               if key.startswith(BENCH_SERVICE_PREFIXES) and key not in BENCH_E2E_SCANNER_FIELDS
               and not key.startswith("fleet_e2e_")}
    check(all(service.get(key) == 1.0 for key in BENCH_SERVICE_EXACT),
          f"bench: a service leg's exact gate did not hold: {service}")
    check(service.get("readpath_cache_hit_pct", 0) >= 99.0 and service.get("store_kills", 0) >= 2,
          f"bench: the readpath or kill-soak leg did not run: {service}")
    observability = {key: value for key, value in secondary.items() if key.startswith(BENCH_OBS_PREFIXES)}
    check(observability.get("analyze_smoke") == "ok" and observability.get("sentinel_clean_regressions") == 0,
          f"bench: the analyze or sentinel leg failed: {observability}")
    report["smoke_service"] = service
    report["smoke_obs"] = {**observability, "kernel_launches_by_leg": by_leg}
    emit("bench", **report)
    return report


class E2EFleet:
    """The ``e2e`` and ``stream`` phases' fleet: 10,000 objects of 3 pods and
    the flat CPU and raw memory samples the in-memory history source
    serves, made with numpy from a seed; ``samples_per_pod`` samples of
    each (the ``distributed`` phase's scans take fewer)."""

    def __init__(self, np, seed: int = 0, samples_per_pod: int = E2E_SAMPLES_PER_POD):
        from krr_tpu_torch.models import K8sObjectData, ResourceAllocations, ResourceType

        started = time.perf_counter()
        self.np = np
        self.samples_per_pod = samples_per_pod
        rng = np.random.default_rng(seed)
        size = E2E_OBJECTS * E2E_PODS * samples_per_pod
        self.cpu_flat = rng.random(size, dtype=np.float32)
        np.multiply(self.cpu_flat, self.cpu_flat, out=self.cpu_flat)
        self.cpu_flat *= np.float32(0.8)
        self.cpu_flat += np.float32(1e-4)
        self.mem_flat = rng.random(size, dtype=np.float32)  # bytes: 50 MB to 4 GB
        self.mem_flat *= np.float32(3.95e9)
        self.mem_flat += np.float32(5e7)
        self.mem_max = self.mem_flat.reshape(E2E_OBJECTS, E2E_PODS, samples_per_pod).max(axis=2).astype(np.float64)
        allocations = ResourceAllocations(
            requests={ResourceType.CPU: "500m", ResourceType.Memory: "1Gi"},
            limits={ResourceType.CPU: None, ResourceType.Memory: "2Gi"},
        )
        self.objects = [
            K8sObjectData(
                name=f"workload-{i}", container="main", namespace=f"ns-{i % 50}", kind="Deployment",
                pods=[f"workload-{i}-pod-{p}" for p in range(E2E_PODS)], allocations=allocations,
            )
            for i in range(E2E_OBJECTS)
        ]
        self.setup_seconds = time.perf_counter() - started

    def scan(self, subset, device: str, strategy: str, **other_args):
        """One ``Runner.run`` over ``subset`` under a recording tracer (its
        stages are the legs, :func:`stage_legs`): (result, runner, wall
        seconds)."""
        from krr_tpu_torch.core.config import Config
        from krr_tpu_torch.core.runner import Runner
        from krr_tpu_torch.models import ResourceType
        from krr_tpu_torch.obs.trace import Tracer

        runner = Runner(
            Config(quiet=True, format="json", device=device, strategy=strategy, other_args=other_args),
            inventory=_Inventory(subset),
            history_factory=lambda cluster: _History(self.np, self.cpu_flat, self.mem_flat, self.mem_max,
                                                     ResourceType, self.samples_per_pod),
            tracer=Tracer(),
        )
        with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
            started = time.perf_counter()
            result = asyncio.run(runner.run())
            wall = time.perf_counter() - started
        return result, runner, wall


def stage_legs(runner) -> dict:
    """The wall seconds of the last scan's compute stages by name (the
    children of its ``compute`` span, summed where a stage opens more than
    once: ``cast`` and ``h2d`` per resource, every stage per row chunk),
    from the recording tracer the runner scanned under."""
    spans = runner.tracer.traces()[-1]
    compute = {span.span_id for span in spans if span.name == "compute"}
    legs: dict = {}
    for span in spans:
        if span.parent_id in compute:
            legs[span.name] = legs.get(span.name, 0.0) + span.duration
    return legs


def stage_path(runner) -> str:
    """The path the last scan's ``quantile`` stage took: ``resident``,
    ``host_stream``, ``mesh``, ``store`` or ``ingest``."""
    return next(span.attributes["path"] for span in runner.tracer.traces()[-1] if span.name == "quantile")


#: The ``e2e`` scans: (strategy, settings, kernels that launch).
E2E_PATHS = {
    "simple": ("simple", {}, {"bisect_select", "row_max"}),
    "tdigest": ("tdigest", {}, {"digest_hist", "row_max"}),
    "tdigest_exact": ("tdigest", {"exact_upgrade": True}, {"topk_select", "row_max"}),
}


def phase_e2e(torch, fleet: E2EFleet) -> tuple[dict, dict]:
    """The three resident scans; returns the report and each path's JSON."""
    from krr_tpu_torch.models import Result

    e2e = {
        "objects": E2E_OBJECTS, "samples_per_object": E2E_PODS * E2E_SAMPLES_PER_POD,
        "setup_seconds": fleet.setup_seconds, "paths": {}, "cpu_recheck_rows": E2E_CPU_CHECK_ROWS,
    }
    rendered = {}
    results = {}
    for path, (strategy, args, launched) in E2E_PATHS.items():
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        result, runner, wall = fleet.scan(fleet.objects, DEVICE, strategy, **args)
        launches, generic_folds = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        render_started = time.perf_counter()
        rendered[path] = result.format("json")
        render_seconds = time.perf_counter() - render_started
        results[path] = result
        check(len(result.scans) == E2E_OBJECTS, f"{path}: {len(result.scans)} scans, expected {E2E_OBJECTS}")
        check('"?"' not in rendered[path], f"{path}: an unknown ('?') value in the scan")
        check(all(launches[name] >= 1 for name in launched), f"{path}: a kernel of the path did not launch: {launches}")
        check(all(launches[name] == 0 for name in launches if name not in launched),
              f"{path}: a kernel of another path launched: {launches}")
        check(not any(generic_folds.values()), f"{path}: a fold took the generic path: {generic_folds}")
        e2e["paths"][path] = {
            "run_wall_seconds": wall, "runner_stats": runner.stats,
            "legs_seconds": {**stage_legs(runner), "render_json": render_seconds},
            "launches": launches, "generic_folds": generic_folds, "json_bytes": len(rendered[path]),
            "peak_device_bytes": peak,
        }
    check(rendered["tdigest_exact"] == rendered["simple"], "tdigest exact_upgrade JSON != simple JSON")

    subset = fleet.objects[:E2E_CPU_CHECK_ROWS]
    head = slice(0, E2E_CPU_CHECK_ROWS)
    for path in ("simple", "tdigest_exact"):
        strategy, args, _ = E2E_PATHS[path]
        cpu_result, _cpu_runner, cpu_wall = fleet.scan(subset, "cpu", strategy, **args)
        check(Result(scans=results[path].scans[head]).format("json") == cpu_result.format("json"),
              f"{path}: the CPU re-run's JSON differs from the GPU scan's")
        e2e["paths"][path]["cpu_recheck_wall_seconds"] = cpu_wall
    cpu_result, _cpu_runner, cpu_wall = fleet.scan(subset, "cpu", "tdigest")
    e2e["paths"]["tdigest"]["cpu_recheck_wall_seconds"] = cpu_wall
    e2e["paths"]["tdigest"]["cpu_recheck_identical_cpu_values"] = same_within_a_bucket(
        Result(scans=results["tdigest"].scans[head]).format("json"), cpu_result.format("json")
    )
    e2e["profiled_simple"] = profiled_scan(fleet, rendered["simple"])
    emit("e2e", **e2e)
    return e2e, rendered


#: Chrome trace categories of the card's own work in a torch.profiler trace.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def traced_device_work(events: list) -> dict:
    """From a torch.profiler Chrome trace: each kernel's launches by its
    function name, the device's busy seconds (the union of kernel, copy and
    set intervals) and the traced window (the first to the last event)."""
    import re

    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in spans
                    if e.get("cat") in DEVICE_CATEGORIES)
    busy, end = 0.0, float("-inf")
    for start, stop in device:  # the union: a copy and a kernel may overlap
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    kernels: dict = {}
    for e in spans:
        if e.get("cat") == "kernel":
            match = re.search(r"(\w+)\(", e["name"])
            name = match.group(1) if match else e["name"]
            kernels[name] = kernels.get(name, 0) + 1
    first = min((float(e["ts"]) for e in spans), default=0.0)
    last = max((float(e["ts"]) + float(e["dur"]) for e in spans), default=0.0)
    by_category = {cat: sum(float(e["dur"]) for e in spans if e.get("cat") == cat) / 1e6
                   for cat in DEVICE_CATEGORIES}
    # How far inside the traced window the card's work lies at each end: the
    # profiler drops a device record that falls outside its window.
    margins = ({"device_head_margin_seconds": (device[0][0] - first) / 1e6,
                "device_tail_margin_seconds": (last - max(stop for _, stop in device)) / 1e6} if device else {})
    return {"kernels": kernels, "busy_seconds": busy / 1e6, "window_seconds": (last - first) / 1e6,
            "seconds_by_category": by_category, "device_records": len(device), **margins}


def profiled_scan(fleet: E2EFleet, reference: str) -> dict:
    """One more ``simple`` scan with ``profile_dir`` set: its JSON equals the
    unprofiled scan's, the profiler trace holds each launched kernel as
    many times as its wrapper counted, and the traced device busy share
    (kernel, copy and set time over the traced window, and over the
    ``Runner.run`` wall) is printed."""
    import glob
    import tempfile

    with tempfile.TemporaryDirectory(prefix="krr-profile-") as tmp:
        _reset_counts()
        result, runner, wall = fleet.scan(fleet.objects, DEVICE, "simple", profile_dir=tmp)
        launches, _generic = _read_counts()
        traces = glob.glob(os.path.join(tmp, "*.pt.trace.json"))
        check(len(traces) == 1, f"profile_dir: {len(traces)} trace files, expected 1")
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        trace_bytes = os.path.getsize(traces[0])
    check(result.format("json") == reference, "e2e: the profiled simple scan's JSON != the unprofiled scan's")
    work = traced_device_work(events)
    for wrapper, kernel in (("bisect_select", "bisect_select_kernel"), ("row_max", "row_max_kernel")):
        check(launches[wrapper] >= 1 and work["kernels"].get(kernel, 0) == launches[wrapper],
              f"profile_dir: {kernel} traced {work['kernels'].get(kernel, 0)} times, its wrapper "
              f"counted {launches[wrapper]} launches; the trace: {work}")
    busy = {
        "busy_share_of_traced_window": work["busy_seconds"] / work["window_seconds"],
        "busy_share_of_run_wall": work["busy_seconds"] / wall,
    }
    legs = stage_legs(runner)
    # The compute leg beyond its stages: the profiler's start, stop and
    # export.
    profiler_seconds = runner.stats["compute_seconds"] - sum(legs.values())
    emit("device_busy", path="simple", run_wall_seconds=wall, profiler_seconds=profiler_seconds, **work, **busy)
    return {"run_wall_seconds": wall, "runner_stats": runner.stats, "legs_seconds": legs, "launches": launches,
            "trace_bytes": trace_bytes, "profiler_seconds": profiler_seconds, **work, **busy}


def phase_stream(torch, fleet: E2EFleet, rendered: "dict | None") -> dict:
    """The ``e2e`` fleet's window streamed from host (``host_stream_mb``):
    four scans through ``Runner.run``, each held to its resident
    reference's JSON byte for byte, with exact launch counts and a peak of
    allocated device memory below ``STREAM_PEAK_BYTES``. ``rendered`` holds
    the ``e2e`` phase's JSON; None builds the references here."""
    chunks = -(-(E2E_PODS * E2E_SAMPLES_PER_POD) // STREAM_CHUNK)
    scans = {
        # path: (strategy, settings, reference path, exact launch counts)
        "simple": ("simple", {}, "simple", {"topk_select": chunks, "row_max": 1}),
        "tdigest": ("tdigest", {}, "tdigest", {"digest_hist": chunks, "row_max": chunks}),
        "tdigest_exact": ("tdigest", {"exact_upgrade": True}, "tdigest_exact",
                          {"topk_select": chunks, "row_max": chunks}),
        "simple_p50": ("simple", {"cpu_percentile": 50}, "simple_p50",
                       {"radix_digit_hist": 3 * chunks, "row_max": 1}),
    }
    references = dict(rendered or {})
    report: dict = {"host_stream_mb": STREAM_MB, "chunk_size": STREAM_CHUNK, "scans": {}, "resident": {}}
    wanted = {"simple_p50": ("simple", {"cpu_percentile": 50})}
    if rendered is None:
        wanted.update({path: (strategy, args) for path, (strategy, args, _) in E2E_PATHS.items()})
    for path, (strategy, args) in wanted.items():  # the resident references
        torch.cuda.reset_peak_memory_stats()
        result, runner, wall = fleet.scan(fleet.objects, DEVICE, strategy, host_stream_mb=-1, **args)
        references[path] = result.format("json")
        check('"?"' not in references[path], f"stream: an unknown ('?') value in the resident {path} scan")
        report["resident"][path] = {"run_wall_seconds": wall, "peak_device_bytes": torch.cuda.max_memory_allocated(),
                                    "legs_seconds": stage_legs(runner)}
    for path, (strategy, args, reference, expected) in scans.items():
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        result, runner, wall = fleet.scan(fleet.objects, DEVICE, strategy, host_stream_mb=STREAM_MB, **args)
        launches, generic_folds = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        strategy_obj = runner.session.strategy
        stream_json = result.format("json")
        check(strategy_obj.stream_stats is not None, f"stream {path}: the scan did not stream")
        check(len(result.scans) == E2E_OBJECTS, f"stream {path}: {len(result.scans)} scans, expected {E2E_OBJECTS}")
        check('"?"' not in stream_json, f"stream {path}: an unknown ('?') value in the scan")
        check(launches == {**{name: 0 for name in launches}, **expected},
              f"stream {path}: launches {launches}, expected {expected} and no other kernel")
        check(not any(generic_folds.values()), f"stream {path}: a fold took the generic path: {generic_folds}")
        check(peak < STREAM_PEAK_BYTES, f"stream {path}: peak allocated device memory {peak} >= {STREAM_PEAK_BYTES}")
        check(stream_json == references[reference], f"stream {path}: JSON != the resident {reference} scan's")
        report["scans"][path] = {
            "run_wall_seconds": wall, "legs_seconds": stage_legs(runner),
            "stream": strategy_obj.stream_stats, "launches": launches, "peak_device_bytes": peak,
        }
    emit("stream", **report)
    return report


def store_arrays(path: str) -> dict:
    """The digest store at ``path`` reopened (manifest, base shards and WAL
    replay, or the legacy file): its keys and arrays."""
    from krr_tpu_torch.core.streaming import DigestStore
    from krr_tpu_torch.ops.digest import DigestSpec

    store = DigestStore.open_or_create(path, DigestSpec())
    return {"keys": list(store.keys), **{f: getattr(store, f) for f in STORE_FIELDS}}


#: The digest store's per-row arrays, all float32.
STORE_FIELDS = ("cpu_counts", "cpu_total", "cpu_peak", "mem_total", "mem_peak")


def same_store_bits(np, a: dict, b: dict) -> bool:
    return a["keys"] == b["keys"] and all(
        a[f].dtype == b[f].dtype == np.float32 and np.array_equal(a[f].view(np.uint32), b[f].view(np.uint32))
        for f in STORE_FIELDS
    )


def bucket_moves(np, a, b) -> tuple[int, int]:
    """(samples that moved, moves wider than one bucket) between two count
    matrices of the same samples: a one-bucket move changes the running
    count at exactly one bucket, so per row ``sum |cumsum(a − b)|`` equals
    the moved samples when every move is one bucket, and exceeds it
    otherwise."""
    diff = a.astype(np.float64) - b.astype(np.float64)
    moved = int(np.abs(diff).sum() // 2)
    return moved, int(np.abs(np.cumsum(diff, axis=1)).sum()) - moved


def wal_records(path: str) -> int:
    """Records in the state directory's live WAL, counted from its frames
    (``[u32 length][u32 crc32][payload]`` after an 8-byte header); 0 after
    a persist that passed the compaction threshold folded them into base
    shards."""
    import struct

    with open(os.path.join(path, "MANIFEST.json")) as f:
        wal = json.load(f)["wal"]
    with open(os.path.join(path, wal), "rb") as f:
        blob = f.read()
    count, pos = 0, 8
    while pos < len(blob):
        (length,) = struct.unpack_from("<I", blob, pos)
        pos += 8 + length
        count += 1
    check(pos == len(blob), f"{path}: a torn WAL frame")
    return count


def phase_state(torch, np, fleet: E2EFleet, rendered: "dict | None") -> dict:
    """``tdigest --state_path`` on the ``e2e`` fleet through ``Runner.run``:
    the window digest on the card (``digest_hist`` and ``row_max`` once
    each, resident; once a chunk, streamed at ``host_stream_mb``), folded
    into the durable store and persisted as one WAL record. The store must
    hold exactly the kernels' outputs (captured from the scan's own calls),
    the streamed state must equal the resident one bit for bit, reopening
    must recover the same arrays, and the render must carry ``e2e``'s
    memory byte for byte and each CPU value within one bucket of it (the
    store answers from the host query). ``rendered`` holds the ``e2e``
    phase's JSON; None runs the resident ``tdigest`` reference here."""
    import tempfile

    from krr_tpu_torch.core.durastore import DurableStore
    from krr_tpu_torch.core.streaming import object_key
    from krr_tpu_torch.ops import digest as digest_ops
    from krr_tpu_torch.ops.digest import DigestSpec
    from krr_tpu_torch.strategies import tdigest as tdigest_module

    report: dict = {"objects": E2E_OBJECTS, "host_stream_mb": STREAM_MB, "scans": {}}
    reference = (rendered or {}).get("tdigest")
    if reference is None:
        result, _runner, wall = fleet.scan(fleet.objects, DEVICE, "tdigest")
        reference = result.format("json")
        report["reference_wall_seconds"] = wall
    chunks = -(-(E2E_PODS * E2E_SAMPLES_PER_POD) // STREAM_CHUNK)
    expected = {"resident": {"digest_hist": 1, "row_max": 1},
                "streamed": {"digest_hist": chunks, "row_max": chunks}}
    captured: dict = {}
    build, row_max = digest_ops.build_from_packed, tdigest_module.masked_max_cuda

    def spy_build(spec, values, counts, *args, **kwargs):
        captured["digest"] = build(spec, values, counts, *args, **kwargs)
        return captured["digest"]

    def spy_row_max(values, counts):
        captured["mem_max"], captured["mem_counts"] = row_max(values, counts), counts
        return captured["mem_max"]

    keys = [object_key(obj) for obj in fleet.objects]
    states = {}
    with tempfile.TemporaryDirectory(prefix="krr-state-smoke-") as tmp:
        for window, extra in (("resident", {}), ("streamed", {"host_stream_mb": STREAM_MB})):
            path = os.path.join(tmp, window)
            digest_ops.build_from_packed, tdigest_module.masked_max_cuda = spy_build, spy_row_max
            try:
                _reset_counts()
                torch.cuda.reset_peak_memory_stats()
                result, runner, wall = fleet.scan(fleet.objects, DEVICE, "tdigest", state_path=path, **extra)
                launches, generic_folds = _read_counts()
            finally:
                digest_ops.build_from_packed, tdigest_module.masked_max_cuda = build, row_max
            strategy = runner.session.strategy
            state_json = result.format("json")
            check(launches == {**{name: 0 for name in launches}, **expected[window]},
                  f"state {window}: launches {launches}, expected {expected[window]} and no other kernel")
            check(not any(generic_folds.values()), f"state {window}: a fold took the generic path: {generic_folds}")
            check((strategy.stream_stats is not None) == (window == "streamed"),
                  f"state {window}: the window did {'not ' if window == 'streamed' else ''}stream")
            check(len(result.scans) == E2E_OBJECTS and '"?"' not in state_json,
                  f"state {window}: {len(result.scans)} scans or an unknown value")
            check(strategy.store_stats["wal_appends"] == 1 and strategy.store_stats["epoch"] == 1,
                  f"state {window}: expected one WAL record appended, store {strategy.store_stats}")
            states[window] = store_arrays(path)
            check(states[window]["keys"] == keys, f"state {window}: store keys != the fleet's object keys")
            identical = same_within_a_bucket(reference, state_json)
            report["scans"][window] = {
                "run_wall_seconds": wall, "legs_seconds": stage_legs(runner),
                "store": {**strategy.store_stats, "live_wal_records": wal_records(path),
                          "base_shards": sum(name.startswith("base-") for name in os.listdir(path))},
                "stream": strategy.stream_stats, "launches": launches,
                "peak_device_bytes": torch.cuda.max_memory_allocated(), "identical_cpu_values": identical,
            }
            if window == "resident":
                digest, mem_max = captured.pop("digest"), captured.pop("mem_max")
                mem_counts = captured.pop("mem_counts")
                kernel = {
                    "cpu_counts": digest.counts.cpu().numpy(), "cpu_total": digest.total.cpu().numpy(),
                    "cpu_peak": digest.peak.cpu().numpy(),
                    "mem_total": mem_counts.cpu().numpy().astype(np.float32),
                    "mem_peak": np.where(np.isnan(m := mem_max.cpu().numpy()), np.float32(-np.inf), m),
                }
                del digest, mem_max, mem_counts
                check(same_store_bits(np, states[window], {"keys": keys, **kernel}),
                      "state: the store's arrays != digest_hist's and row_max's outputs on the window")
                started = time.perf_counter()
                durable = DurableStore.open(path, DigestSpec())
                recovered = {"keys": list(durable.store.keys),
                             **{f: getattr(durable.store, f) for f in STORE_FIELDS}}
                epoch = durable.epoch
                durable.close()
                report["reopen_seconds"] = time.perf_counter() - started
                check(epoch == 1 and same_store_bits(np, recovered, states[window]),
                      "state: reopening the state did not recover the same arrays")
    check(same_store_bits(np, states["streamed"], states["resident"]),
          "state: the streamed window's store != the resident window's")
    emit("state", **report)
    return report


#: The ``mesh`` phase's meshes over the one card, as (data, time): one row
#: block per shard (K1 per block), and two time shards per block (the K5
#: radix route).
MESH_SHAPES = ((4, 1), (2, 2))
#: The ``mesh`` and ``distributed`` phases' scans' depth, samples per pod:
#: a quarter of ``e2e``'s 40,320 (1.75 days at 5 s), at ``e2e``'s width
#: (10,000 objects × 3 pods). One fleet and its resident scans
#: (:func:`resident_scans`) serve both phases' references; each rank of
#: ``distributed`` holds a fleet of its own (``e2e``'s would be 9.7 GB a
#: rank), and the script stays well inside its time limit.
MESH_SAMPLES_PER_POD = 10_080
#: The ``mesh`` phase's scans on a (2, 2) mesh of the card: (strategy,
#: settings, exact launch counts). Four shards: q = 99 takes the radix
#: route (3 digits × 4 shards of ``radix_digit_hist``), each sketch one
#: launch a shard, the memory max one ``row_max`` a shard.
MESH_SCANS = {
    "simple": ("simple", {}, {"radix_digit_hist": 12, "row_max": 4}),
    "tdigest": ("tdigest", {}, {"digest_hist": 4, "row_max": 4}),
    "tdigest_exact": ("tdigest", {"exact_upgrade": True}, {"topk_select": 4, "row_max": 4}),
}


def _counted(label: str, expected: dict, fn):
    """(fn's result, its launches, its host wall): every count set to 0
    just before ``fn`` and read just after, and held to ``expected`` with no
    other kernel and no generic fold."""
    _reset_counts()
    started = time.perf_counter()
    result = fn()
    wall = time.perf_counter() - started
    launches, generic_folds = _read_counts()
    check(launches == {**{name: 0 for name in launches}, **expected},
          f"mesh {label}: launches {launches}, expected {expected} and no other kernel")
    check(not any(generic_folds.values()), f"mesh {label}: a fold took the generic path: {generic_folds}")
    return result, launches, wall


def _shard_kernel_ms(torch, mesh, host_values, host_counts, q: float, resident_p) -> dict:
    """CUDA-event medians of each kernel on each shard of ``mesh`` (the
    blocks ``transfer_to_mesh`` places), and for a mesh with time shards
    the ``radix_digit_hist`` time of each shard in each pass of the radix
    select, whose answer must equal ``bisect_select``'s rows."""
    from krr_tpu_torch import parallel
    from krr_tpu_torch.ops import cuda_select, cuda_sketch
    from krr_tpu_torch.ops.selection import RadixSelect

    values_d, counts_d, _rows = parallel.transfer_to_mesh(host_values, host_counts, mesh)
    shard_ms: dict = {"row_max": [], "digest_hist": [], "topk_select": [], "bisect_select": [],
                      "radix_digit_hist": []}
    passes = []
    rows = 0
    for row_values, row_counts in zip(values_d, counts_d):
        width = row_values[0].shape[1]
        effs = [torch.clamp(c - j * width, 0, width).to(torch.int32) for j, c in enumerate(row_counts)]
        for v, eff in zip(row_values, effs):
            shard_ms["row_max"].append(statistics.median(cuda_ms(torch, lambda: cuda_select.row_max_chunk(v, eff))))
            shard_ms["digest_hist"].append(statistics.median(cuda_ms(torch, lambda: cuda_sketch.digest_hist(
                v, eff, DIGEST_BUCKETS, DIGEST_MIN_VALUE, DIGEST_LOG_GAMMA))))
            shard_ms["topk_select"].append(statistics.median(cuda_ms(
                torch, lambda: cuda_sketch.topk_select(v, eff, TOPK_K))))
        block = slice(rows, rows + row_values[0].shape[0])
        rows = block.stop
        if len(row_values) == 1:
            shard_ms["bisect_select"].append(statistics.median(cuda_ms(
                torch, lambda: cuda_select.masked_percentile_bisect_cuda(row_values[0], row_counts[0], q))))
            continue
        home = row_counts[0].device
        plan = RadixSelect(row_counts[0], q, width * len(row_values))
        live = [torch.clamp(plan.live.to(v.device) - j * width, 0, width).to(torch.int32)
                for j, v in enumerate(row_values)]

        def count_pass(prefix32, shift, bits, row_values=row_values, live=live):
            total, times = None, []
            for v, eff in zip(row_values, live):
                prefix = prefix32.to(v.device)
                scratch = torch.zeros((v.shape[0], 1 << bits), dtype=torch.int32, device=v.device)
                times.append(statistics.median(cuda_ms(
                    torch, lambda: cuda_select.radix_digit_hist(v, eff, prefix, scratch, shift, bits))))
                bins = cuda_select.radix_digit_hist(v, eff, prefix, torch.zeros_like(scratch), shift, bits)
                total = bins.to(home) if total is None else total + bins.to(home)
            passes.append({"shift": shift, "bits": bits, "shard_ms": times})
            shard_ms["radix_digit_hist"].extend(times)
            return total

        check(same_bits(torch, plan.run(count_pass), resident_p[block]),
              "mesh: the per-pass radix select != bisect_select's rows")
    del values_d, counts_d
    return {"shard_ms": shard_ms, "radix_passes": passes,
            "sum_ms": {name: sum(times) for name, times in shard_ms.items() if times}}


def same_as_resident(np, name: str, result, resident: dict) -> bool:
    """Whether a sharded function's ``result`` equals the resident kernels'
    (:func:`mesh_resident`) bit for bit: the digest's counts, totals and
    peaks, the top-K as sorted rows and its totals, a per-row array
    otherwise."""
    from krr_tpu_torch import parallel

    if name == "fleet_digest":
        blocks, rows = result
        return all(np.array_equal(parallel.gather_rows(blocks, lambda d, i=i: d[i], rows).view(np.uint32),
                                  resident[field].view(np.uint32))
                   for i, field in enumerate(("counts", "total", "peak")))
    if name == "fleet_topk":
        blocks, rows = result
        top = parallel.gather_rows(blocks, lambda s: s.values, rows)
        return (np.array_equal(np.sort(top.view(np.int32), axis=1), resident["topk_sorted"])
                and np.array_equal(parallel.gather_rows(blocks, lambda s: s.total, rows), resident["topk_total"]))
    return np.array_equal(result.view(np.uint32), resident[name].view(np.uint32))


def _mesh_functions(torch, np, mesh, host_values, host_counts, q: float, resident: dict, resident_p) -> dict:
    """Each sharded function on ``mesh`` against the resident kernels'
    results, bit for bit, with its exact launches; then the kernels' times
    per shard."""
    from krr_tpu_torch import parallel
    from krr_tpu_torch.ops.digest import DigestSpec
    from krr_tpu_torch.ops.selection import STREAM_DIGITS

    data, time_shards = mesh.shape["data"], mesh.shape["time"]
    shards = mesh.size
    out: dict = {"shape": [data, time_shards], "devices": [str(d) for d in mesh.flat()], "functions": {}}
    select = {"bisect_select": data} if time_shards == 1 else {"radix_digit_hist": len(STREAM_DIGITS) * shards}
    spec = DigestSpec(gamma=1.01, min_value=DIGEST_MIN_VALUE, num_buckets=DIGEST_BUCKETS)
    runs = {
        "percentile_bisect": (select, lambda: parallel.sharded_percentile_bisect(host_values, host_counts, q, mesh)),
        "masked_max": ({"row_max": shards}, lambda: parallel.sharded_masked_max(host_values, host_counts, mesh)),
        "fleet_digest": ({"digest_hist": shards},
                         lambda: parallel.sharded_fleet_digest(spec, host_values, host_counts, mesh)),
        "fleet_topk": ({"topk_select": shards},
                       lambda: parallel.sharded_fleet_topk(host_values, host_counts, TOPK_K, mesh)),
    }
    for name, (expected, fn) in runs.items():
        result, launches, wall = _counted(f"{data}x{time_shards} {name}", expected, fn)
        check(same_as_resident(np, name, result, resident),
              f"mesh {data}x{time_shards}: sharded {name} != the resident kernel's result")
        out["functions"][name] = {"wall_seconds": wall, "launches": launches}
    out.update(_shard_kernel_ms(torch, mesh, host_values, host_counts, q, resident_p))
    return out


#: The percentile of the ``mesh`` and ``distributed`` phases' functions.
MESH_Q = 99.0


def mesh_matrix(torch, dev):
    """The ``mesh`` and ``distributed`` phases' matrix on ``dev``: 10,000 ×
    120,960 CPU-like float32 from a seeded generator, every 7th row cut to
    a seeded count, the first 8 rows empty; (values, counts)."""
    n, t = HEADLINE_ROWS, HEADLINE_T
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    values = torch.rand((n, t), generator=gen, device=dev, dtype=torch.float32)
    values.mul_(values).mul_(0.8).add_(1e-4)
    cut = torch.randint(0, t + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
    counts = torch.where(torch.arange(n, device=dev) % 7 == 3, cut, torch.full_like(cut, t))
    counts[:8] = 0
    return values, counts


def mesh_resident(torch, np, values, counts) -> tuple[dict, dict, object]:
    """The resident kernels on the whole matrix: (each one's CUDA-event
    median ms, their host results — K1's percentile, K2's max, K3's
    digest and its p99, K4's sorted top-K and totals — and K1's result on
    the card)."""
    from krr_tpu_torch.ops import cuda_select
    from krr_tpu_torch.ops import digest as digest_ops
    from krr_tpu_torch.ops import topk_sketch as topk_ops
    from krr_tpu_torch.ops.digest import DigestSpec

    spec = DigestSpec(gamma=1.01, min_value=DIGEST_MIN_VALUE, num_buckets=DIGEST_BUCKETS)
    kernels = {
        "bisect_select": lambda: cuda_select.masked_percentile_bisect_cuda(values, counts, MESH_Q),
        "row_max": lambda: cuda_select.masked_max_cuda(values, counts),
        "digest_hist": lambda: digest_ops.build_from_packed(spec, values, counts),
        "topk_select": lambda: topk_ops.build_from_packed(values, counts, TOPK_K),
    }
    resident_ms = {name: statistics.median(cuda_ms(torch, fn)) for name, fn in kernels.items()}
    resident_p = kernels["bisect_select"]()
    digest = kernels["digest_hist"]()
    sketch = kernels["topk_select"]()
    resident = {
        "percentile_bisect": resident_p.cpu().numpy(), "masked_max": kernels["row_max"]().cpu().numpy(),
        "counts": digest.counts.cpu().numpy(), "total": digest.total.cpu().numpy(), "peak": digest.peak.cpu().numpy(),
        "percentile": digest_ops.percentile(spec, digest, MESH_Q).cpu().numpy(),
        "topk_sorted": np.sort(sketch.values.cpu().numpy().view(np.int32), axis=1),
        "topk_total": sketch.total.cpu().numpy(),
    }
    return resident_ms, resident, resident_p


def phase_mesh(torch, np, fleet: E2EFleet, references: dict) -> dict:
    """The device mesh (`krr_tpu_torch.parallel`) on the card. Functions: on
    the headline matrix (10,000 × 120,960 CPU-like float32 made on the card
    from a seed; every 7th row cut to a seeded count, the first 8 empty),
    each sharded function on (4, 1) and (2, 2) meshes of the card four
    times, and on the distinct cards when there are two or more, must
    equal the resident ``bisect_select``, ``row_max``, ``digest_hist`` and
    ``topk_select`` results bit for bit, with exact launches; each kernel's
    time per shard (CUDA events) is printed beside the resident kernel's,
    and the radix route's ``radix_digit_hist`` time per shard and pass.
    Scans: ``simple``, ``tdigest`` and ``tdigest --exact_upgrade`` through
    ``Runner.run`` on ``fleet`` (``e2e``'s width at
    :data:`MESH_SAMPLES_PER_POD`) with ``mesh_time_axis=2`` and the
    strategies' device seam (``mesh_devices``) giving the card four times:
    a (2, 2) mesh. Each must render the resident scan's JSON
    (``references``, :func:`resident_scans`) byte for byte with the exact
    launches of :data:`MESH_SCANS`, no generic fold, 10,000 rows and no
    ``?``."""
    import krr_tpu_torch.strategies.simple as simple_module
    from krr_tpu_torch import parallel

    dev = torch.device(DEVICE)
    n, t, q = HEADLINE_ROWS, HEADLINE_T, MESH_Q
    values, counts = mesh_matrix(torch, dev)
    resident_ms, resident, resident_p = mesh_resident(torch, np, values, counts)
    host_values, host_counts = values.cpu().numpy(), counts.cpu().numpy()
    del values
    torch.cuda.empty_cache()
    meshes = {f"card_{d}x{s}": parallel.make_mesh(d, s, devices=[dev] * (d * s)) for d, s in MESH_SHAPES}
    cards = parallel.mesh_devices(DEVICE)
    if len(cards) >= 2:
        meshes[f"cards_{len(cards)}x1"] = parallel.make_mesh(devices=cards)
    report: dict = {"shape": [n, t], "q": q, "resident_ms": resident_ms, "meshes": {}, "scans": {}}
    for name, mesh in meshes.items():
        report["meshes"][name] = _mesh_functions(torch, np, mesh, host_values, host_counts, q, resident,
                                                 resident_p)
    del host_values, host_counts, resident, resident_p, counts
    torch.cuda.empty_cache()

    report["samples_per_pod"] = fleet.samples_per_pod
    seam = simple_module.mesh_devices
    simple_module.mesh_devices = lambda device: [dev] * 4
    try:
        for path, (strategy, args, expected) in MESH_SCANS.items():
            torch.cuda.reset_peak_memory_stats()
            (result, runner, wall), launches, _wall = _counted(
                f"scan {path}", expected,
                lambda: fleet.scan(fleet.objects, DEVICE, strategy, mesh_time_axis=2, **args))
            scan_json = result.format("json")
            legs = stage_legs(runner)
            check(stage_path(runner) == "mesh",
                  f"mesh scan {path}: the scan took the {stage_path(runner)} path (legs {sorted(legs)})")
            check(len(result.scans) == E2E_OBJECTS and '"?"' not in scan_json,
                  f"mesh scan {path}: {len(result.scans)} scans or an unknown value")
            check(scan_json == references[path]["json"], f"mesh scan {path}: JSON != the resident {path} scan's")
            report["scans"][path] = {"run_wall_seconds": wall, "runner_stats": runner.stats, "legs_seconds": legs,
                                     "launches": launches, "peak_device_bytes": torch.cuda.max_memory_allocated()}
    finally:
        simple_module.mesh_devices = seam
    emit("mesh", **report)
    return report


#: The ``distributed`` phase: ranks (child processes) on one process group.
DIST_RANKS = 2
#: Its functions' meshes, as (data, time), over the ranks' devices: each
#: rank brings its device once, or twice for (2, 2).
DIST_MESHES = {(2, 1): 1, (1, 2): 1, (2, 2): 2}
#: Its scans' global meshes, by ``mesh_time_axis``.
DIST_SCAN_MESHES = {1: (2, 1), 2: (1, 2)}
#: Its host-streamed scans on the global (2, 1) mesh, with the window past
#: :data:`DIST_STREAM_MB` a device: (strategy, settings); each rank streams
#: its own rows and the blocks' results are gathered to both.
DIST_STREAMED = {"simple": ("simple", {}), "tdigest": ("tdigest", {})}
DIST_STREAM_MB = 100
#: Seconds the ranks may take, start to end, before the phase kills them.
DIST_DEADLINE = 600.0


def _dist_function_launches(data: int, time_shards: int) -> dict:
    """Each function's exact launches on one rank of a (data, time) mesh
    whose cells split evenly over the ranks: a launch per shard it owns (K1
    per row block with one time shard; K5 per shard and digit with more)."""
    from krr_tpu_torch.ops.selection import STREAM_DIGITS

    shards = data * time_shards // DIST_RANKS
    select = {"bisect_select": shards} if time_shards == 1 else {"radix_digit_hist": len(STREAM_DIGITS) * shards}
    return {"percentile_bisect": select, "masked_max": {"row_max": shards}, "fleet_digest": {"digest_hist": shards},
            "percentile": {}, "fleet_topk": {"topk_select": shards}}


def _dist_scan_launches(path: str, time_axis: int) -> dict:
    """A scan's exact launches on one rank of the two-rank (2, 1) or (1, 2)
    mesh: one shard a rank; q = 99 on (1, 2) takes the radix route."""
    from krr_tpu_torch.ops.selection import STREAM_DIGITS

    cpu = {"simple": {"bisect_select": 1} if time_axis == 1 else {"radix_digit_hist": len(STREAM_DIGITS)},
           "tdigest": {"digest_hist": 1}, "tdigest_exact": {"topk_select": 1}}[path]
    return {**cpu, "row_max": 1}


def _dist_streamed_launches(path: str) -> dict:
    """A host-streamed scan's exact launches on one rank of the (2, 1)
    mesh: its block of rows streams in the window's time chunks, each one
    sketch launch (``simple``'s q = 99 the top-K) and, for ``tdigest``,
    one ``row_max``; ``simple``'s memory window is one chunk."""
    chunks = -(-(E2E_PODS * MESH_SAMPLES_PER_POD) // STREAM_CHUNK)
    return {"simple": {"topk_select": chunks, "row_max": 1},
            "tdigest": {"digest_hist": chunks, "row_max": chunks}}[path]


def _dist_shard_ms(torch, dist, world, mesh, host_values, host_counts) -> dict:
    """CUDA-event medians of each kernel on each of this rank's shards of
    ``mesh`` (K1 on a row block with one time shard, K5's first pass under
    a zero prefix with more): timed with every rank timing at once (the
    ranks that share a card slice it), then one rank at a time."""
    from krr_tpu_torch import parallel
    from krr_tpu_torch.ops import cuda_select, cuda_sketch

    values_d, counts_d, _rows = parallel.transfer_to_mesh(host_values, host_counts, mesh)
    shards = [(j, v, c) for row_v, row_c in zip(values_d, counts_d) for j, (v, c) in enumerate(zip(row_v, row_c))
              if v is not None]

    def timed() -> dict:
        out: dict = {"row_max": [], "digest_hist": [], "topk_select": [], "bisect_select": [], "radix_digit_hist": []}
        for j, v, c in shards:
            width = v.shape[1]
            eff = torch.clamp(c - j * width, 0, width).to(torch.int32)
            runs = {
                "row_max": lambda: cuda_select.row_max_chunk(v, eff),
                "digest_hist": lambda: cuda_sketch.digest_hist(v, eff, DIGEST_BUCKETS, DIGEST_MIN_VALUE,
                                                               DIGEST_LOG_GAMMA),
                "topk_select": lambda: cuda_sketch.topk_select(v, eff, TOPK_K),
            }
            if mesh.shape["time"] == 1:
                runs["bisect_select"] = lambda: cuda_select.masked_percentile_bisect_cuda(v, c, MESH_Q)
            else:
                prefix = torch.zeros(v.shape[0], dtype=torch.int32, device=v.device)
                bins = torch.zeros((v.shape[0], 1 << 11), dtype=torch.int32, device=v.device)
                runs["radix_digit_hist"] = lambda: cuda_select.radix_digit_hist(v, eff, prefix, bins, 21, 11)
            for name, fn in runs.items():
                out[name].append(statistics.median(cuda_ms(torch, fn)))
        return {name: times for name, times in out.items() if times}

    dist.barrier()
    together = timed()
    lone = None
    for rank in range(world.size):
        dist.barrier()
        if rank == world.rank:
            lone = timed()
    dist.barrier()
    return {"together_ms": together, "lone_ms": lone}


def _dist_functions(torch, np, dist, world, workdir: str) -> dict:
    """Each sharded function on each mesh of :data:`DIST_MESHES` at the
    headline shape: equal, bit for bit, to the resident kernels' results
    the parent shipped, with this rank's exact launches; its host wall,
    its collectives' calls, bytes and seconds, and the host RSS; then the
    kernels' per-shard times."""
    from krr_tpu_torch import parallel
    from krr_tpu_torch.ops.digest import DigestSpec
    from krr_tpu_torch.parallel import collectives
    from krr_tpu_torch.parallel.mesh import MeshDevice

    values, counts = mesh_matrix(torch, world.device)
    host_values, host_counts = values.cpu().numpy(), counts.cpu().numpy()
    del values, counts
    torch.cuda.empty_cache()
    resident = dict(np.load(os.path.join(workdir, "resident.npz")))
    spec = DigestSpec(gamma=1.01, min_value=DIGEST_MIN_VALUE, num_buckets=DIGEST_BUCKETS)
    out = {}
    for (data, time_shards), per_rank in DIST_MESHES.items():
        devices = [MeshDevice(cell.rank, cell.device) for cell in world.devices for _ in range(per_rank)]
        mesh = parallel.make_mesh(data, time_shards, devices=devices)
        expected = _dist_function_launches(data, time_shards)
        built: dict = {}

        def build_digest(mesh=mesh):
            built["digest"] = parallel.sharded_fleet_digest(spec, host_values, host_counts, mesh)
            return built["digest"]

        runs = {
            "percentile_bisect": lambda: parallel.sharded_percentile_bisect(host_values, host_counts, MESH_Q, mesh),
            "masked_max": lambda: parallel.sharded_masked_max(host_values, host_counts, mesh),
            "fleet_digest": build_digest,
            "percentile": lambda: parallel.sharded_percentile(spec, built["digest"][0], MESH_Q, built["digest"][1]),
            "fleet_topk": lambda: parallel.sharded_fleet_topk(host_values, host_counts, TOPK_K, mesh),
        }
        label = f"distributed rank {world.rank} {data}x{time_shards}"
        report: dict = {"devices": [[cell.rank, str(cell.device)] for cell in mesh.cells()], "functions": {}}
        for name, fn in runs.items():
            collectives.reset_stats()
            dist.barrier()
            result, launches, wall = _counted(f"{label} {name}", expected[name], fn)
            check(same_as_resident(np, name, result, resident),
                  f"{label}: sharded {name} != the resident kernel's result")
            report["functions"][name] = {
                "wall_seconds": wall, "launches": {k: v for k, v in launches.items() if v},
                "collectives": {op: dict(stats) for op, stats in collectives.STATS.items()},
                "rss_bytes": _rss_bytes(),
            }
        del built
        report.update(_dist_shard_ms(torch, dist, world, mesh, host_values, host_counts))
        out[f"{data}x{time_shards}"] = report
    return out


def _dist_scans(torch, np, dist, world, workdir: str) -> dict:
    """``Runner.run`` of the ``e2e`` paths on the global meshes of
    :data:`DIST_SCAN_MESHES` (the strategies resolve them from the process
    group), then of :data:`DIST_STREAMED` host-streamed on (2, 1), on a
    fleet of :data:`MESH_SAMPLES_PER_POD`: each JSON equals the parent's
    resident scan's byte for byte, with this rank's exact launches, no
    generic fold, 10,000 rows and no ``?``."""
    fleet = E2EFleet(np, samples_per_pod=MESH_SAMPLES_PER_POD)
    out: dict = {"fleet_seconds": fleet.setup_seconds, "rss_bytes_after_fleet": _rss_bytes()}
    scans = [(time_axis, path, strategy, args, {}, _dist_scan_launches(path, time_axis))
             for time_axis in DIST_SCAN_MESHES for path, (strategy, args, _launched) in E2E_PATHS.items()]
    scans += [(1, path, strategy, {**args, "host_stream_mb": DIST_STREAM_MB}, {"streamed": True},
               _dist_streamed_launches(path)) for path, (strategy, args) in DIST_STREAMED.items()]
    for time_axis, path, strategy, args, how, expected in scans:
        shape = DIST_SCAN_MESHES[time_axis]
        with open(os.path.join(workdir, f"scan-{path}.json")) as f:
            reference = f.read()
        name = f"{path}_{shape[0]}x{shape[1]}" + ("_streamed" if how else "")
        label = f"distributed rank {world.rank} scan {name}"
        dist.barrier()
        (result, runner, wall), launches, _wall = _counted(
            label, expected, lambda: fleet.scan(fleet.objects, DEVICE, strategy, mesh_time_axis=time_axis, **args))
        scan_json = result.format("json")
        strategy_obj = runner.session.strategy
        legs = stage_legs(runner)
        took = {"host_stream": "streamed", "resident": "resident", "mesh": "mesh"}[stage_path(runner)]
        check(took == ("streamed" if how else "mesh"), f"{label}: the scan took the {took} path")
        check(len(result.scans) == E2E_OBJECTS and '"?"' not in scan_json,
              f"{label}: {len(result.scans)} scans or an unknown value")
        check(scan_json == reference, f"{label}: JSON != the resident scan's")
        out[name] = {"run_wall_seconds": wall, "legs_seconds": legs, "launches": {k: v for k, v in launches.items() if v},
                     "stream": strategy_obj.stream_stats}
    out["rss_bytes"] = _rss_bytes()
    return out


def _distributed_rank(rank: int, port: int, workdir: str, visible: "str | None") -> None:
    """One rank of the ``distributed`` phase, in a child process: the
    launcher's variables (and, given ``visible``, a ``CUDA_VISIBLE_DEVICES``
    of this rank's one card), ``initialize_distributed()`` from them, the
    functions, the scans; its report to ``rank-<rank>.json``."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(DIST_RANKS), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(DIST_RANKS))
    if visible is not None:
        os.environ["CUDA_VISIBLE_DEVICES"] = visible
    import numpy as np
    import torch
    import torch.distributed as dist

    from krr_tpu_torch.parallel import initialize_distributed

    started = time.perf_counter()
    world = initialize_distributed(device=DEVICE)
    report = {"rank": world.rank, "backend": world.backend, "device": str(world.device),
              "devices": [[cell.rank, str(cell.device)] for cell in world.devices], "cards": list(world.cards),
              "visible": visible, "init_seconds": time.perf_counter() - started}
    report["functions"] = _dist_functions(torch, np, dist, world, workdir)
    report["scans"] = _dist_scans(torch, np, dist, world, workdir)
    report["wall_seconds"] = time.perf_counter() - started
    with open(os.path.join(workdir, f"rank-{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def resident_scans(fleet: E2EFleet) -> dict:
    """The resident ``e2e`` scans of ``fleet`` that the ``mesh`` and
    ``distributed`` phases' scans are held to: each path's JSON and wall."""
    out = {}
    for path, (strategy, args, _launched) in E2E_PATHS.items():
        result, _runner, wall = fleet.scan(fleet.objects, DEVICE, strategy, **args)
        rendered = result.format("json")
        check(len(result.scans) == E2E_OBJECTS and '"?"' not in rendered,
              f"resident {path} scan at {fleet.samples_per_pod} samples a pod: {len(result.scans)} scans or an "
              "unknown value")
        out[path] = {"json": rendered, "wall_seconds": wall}
    return out


def phase_distributed(torch, np, references: dict) -> dict:
    """The mesh across processes (`krr_tpu_torch.parallel.
    initialize_distributed`, M7b): see the module docstring. The parent
    writes the references (the resident kernels on the headline matrix;
    ``references``, the resident scans of :func:`resident_scans` at
    :data:`MESH_SAMPLES_PER_POD`), then starts :data:`DIST_RANKS` ranks
    together; one that fails, or the deadline, kills the others and fails
    the phase. With a card a rank, each rank sees only its own
    (``CUDA_VISIBLE_DEVICES``), and the ranks must agree on ``nccl``; on
    one card they share it and must agree on ``gloo``."""
    import multiprocessing
    import socket
    import tempfile

    dev = torch.device(DEVICE)
    cards = torch.cuda.device_count()
    shown = os.environ.get("CUDA_VISIBLE_DEVICES")
    shown = shown.split(",") if shown else [str(i) for i in range(cards)]
    visible = [shown[rank] for rank in range(DIST_RANKS)] if cards >= DIST_RANKS else [None] * DIST_RANKS
    want_backend = "nccl" if cards >= DIST_RANKS else "gloo"
    report: dict = {"ranks": DIST_RANKS, "samples_per_pod": MESH_SAMPLES_PER_POD,
                    "e2e_samples_per_pod": E2E_SAMPLES_PER_POD, "objects": E2E_OBJECTS, "pods": E2E_PODS,
                    "visible": visible, "stream_mb": DIST_STREAM_MB}
    with tempfile.TemporaryDirectory(prefix="krr-distributed-") as workdir:
        started = time.perf_counter()
        values, counts = mesh_matrix(torch, dev)
        report["resident_ms"], resident, _resident_p = mesh_resident(torch, np, values, counts)
        del values, counts, _resident_p
        torch.cuda.empty_cache()
        np.savez(os.path.join(workdir, "resident.npz"), **resident)
        del resident
        for path, reference in references.items():
            with open(os.path.join(workdir, f"scan-{path}.json"), "w") as f:
                f.write(reference["json"])
        report["references_seconds"] = time.perf_counter() - started
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_distributed_rank, args=(rank, port, workdir, visible[rank]), daemon=True)
                 for rank in range(DIST_RANKS)]
        started = time.perf_counter()
        try:
            for proc in procs:
                proc.start()
            while any(proc.is_alive() for proc in procs):
                failed = [proc for proc in procs if proc.exitcode not in (None, 0)]
                check(not failed, f"distributed: a rank exited {failed[0].exitcode if failed else 0}")
                check(time.perf_counter() - started < DIST_DEADLINE,
                      f"distributed: the ranks ran past {DIST_DEADLINE} s")
                time.sleep(0.2)
            check(all(proc.exitcode == 0 for proc in procs),
                  f"distributed: rank exit codes {[proc.exitcode for proc in procs]}")
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                proc.join(timeout=30)
        report["ranks_seconds"] = time.perf_counter() - started
        report["rank_reports"] = []
        for rank in range(DIST_RANKS):
            with open(os.path.join(workdir, f"rank-{rank}.json")) as f:
                report["rank_reports"].append(json.load(f))
    backends = {r["backend"] for r in report["rank_reports"]}
    check(backends == {want_backend},
          f"distributed: the ranks chose {sorted(backends)} on {cards} card(s), expected {want_backend}")
    report["backend"] = want_backend
    emit("distributed", **report)
    return report


def same_within_a_bucket(card_json: str, cpu_json: str, cpu_within: bool = True) -> int:
    """Hold a tdigest scan's JSON on the CPU to the card's: the same objects
    and memory, each CPU request within one bucket (``cpu_within=False``:
    the CPU requests unchecked). Returns how many CPU requests are
    identical."""
    card = json.loads(card_json, parse_float=Decimal)["scans"]
    host = json.loads(cpu_json, parse_float=Decimal)["scans"]
    check(len(card) == len(host), f"tdigest: {len(host)} scans on the CPU, {len(card)} on the card")
    check('"?"' not in cpu_json, "tdigest: an unknown ('?') value in the CPU run")
    one_bucket = Decimal("0.01")  # γ − 1 at the default spec
    same = 0
    for a, b in zip(card, host):
        check(a["object"] == b["object"], "tdigest: the CPU run's objects differ from the card's")
        for kind in ("requests", "limits"):
            check(a["recommended"][kind]["memory"] == b["recommended"][kind]["memory"],
                  f"tdigest: memory {kind} differ between the card and the CPU")
        x = a["recommended"]["requests"]["cpu"]["value"]
        y = b["recommended"]["requests"]["cpu"]["value"]
        # One bucket is a factor γ; the millicore ceiling adds up to 0.001.
        check(not cpu_within or abs(x - y) <= one_bucket * max(x, y) + Decimal("0.001"),
              f"tdigest CPU {x} on the card vs {y} on the CPU")
        same += x == y
    return same


def _serve_fixture(n_objects: int, samples: int, conn, namespaces: int = 1) -> None:
    """Child-process entry (multiprocessing ``spawn``): build the fake
    cluster and Prometheus, serve them on localhost, report the port and the
    series origin, and hold until the parent is done. One namespace is
    ``default``; more are ``ns-0`` … in equal consecutive blocks."""
    import numpy as np

    from tests.fakes.servers import FakeBackend, FakeCluster, FakeMetrics, ServerThread

    started = time.perf_counter()
    cluster = FakeCluster()
    metrics = FakeMetrics()
    # Range-accurate serving: each split window gets exactly its slice.
    metrics.enforce_range = True
    rng = np.random.default_rng(5)
    per_namespace = -(-n_objects // namespaces)
    for i in range(n_objects):
        namespace = "default" if namespaces == 1 else f"ns-{i // per_namespace}"
        (pod,) = cluster.add_workload_with_pods("Deployment", f"wl-{i}", namespace, pod_count=1)
        # Realistic precision (irates ~0.1 millicore, page-granular working
        # sets), as bench_e2e.py quantises them: iid full-precision
        # mantissas would benchmark the RNG's entropy on the wire.
        metrics.set_series(
            namespace, "main", pod,
            cpu=np.round(rng.gamma(2.0, 0.05, samples), 4),
            memory=np.floor(rng.uniform(5e7, 4e8, samples) / 4096) * 4096,
        )
    backend = FakeBackend(cluster, metrics)
    server = ServerThread(backend).start()
    conn.send((server.port, FakeBackend.SERIES_ORIGIN, time.perf_counter() - started))
    # "counts" asks for the apiserver request counters and the Prometheus
    # request count; ("push", port, i0, i1) remote-writes grid indices
    # [i0, i1] of every series to an ingest listener; anything else (the
    # parent's "done", or a closed pipe) stops the fixture.
    with contextlib.suppress(EOFError, OSError):
        while True:
            message = conn.recv()
            if message == "counts":
                conn.send({"lists": backend.list_request_count, "pod_lists": backend.pod_request_count,
                           "watches": backend.watch_request_count, "prom_requests": metrics.request_count})
            elif isinstance(message, tuple) and message[0] == "push":
                conn.send(_remote_write(metrics, *message[1:]))
            else:
                break
    server.stop()


#: Prometheus's default ``queue_config.max_samples_per_send``: the most
#: samples one remote-write body carries.
PUSH_SAMPLES_PER_BODY = 2_000


def _remote_write(metrics, port: int, i0: int, i1: int) -> dict:
    """Remote-write grid indices [i0, i1] of every series the fake serves,
    as a Prometheus sender would: bodies of at most
    ``PUSH_SAMPLES_PER_BODY`` samples (a series split across bodies in time
    order), POSTed in order over one kept-alive connection. Returns the
    bodies, samples and bytes sent, the encode and send seconds and the
    status codes."""
    import http.client
    from collections import Counter

    from tests.fakes.remote_write import build_body, cpu_labels, mem_labels
    from tests.fakes.servers import FakeBackend

    started = time.perf_counter()
    bodies, batch, room, samples_total = [], [], PUSH_SAMPLES_PER_BODY, 0
    for (namespace, container, pod), (cpu, mem) in sorted(metrics.series.items()):
        for labels, values in ((cpu_labels(namespace, pod, container), cpu),
                               (mem_labels(namespace, pod, container), mem)):
            hi = min(i1, len(values) - 1)
            samples = [(float(values[i]), int(round((FakeBackend.SERIES_ORIGIN + i * CLI_STEP_SECONDS) * 1000.0)))
                       for i in range(max(i0, 0), hi + 1)]
            samples_total += len(samples)
            while samples:
                take, samples = samples[:room], samples[room:]
                batch.append((labels, take))
                room -= len(take)
                if room == 0:
                    bodies.append(build_body(batch))
                    batch, room = [], PUSH_SAMPLES_PER_BODY
    if batch:
        bodies.append(build_body(batch))
    encode_seconds = time.perf_counter() - started
    statuses: Counter = Counter()
    connection = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    started = time.perf_counter()
    try:
        for body in bodies:
            connection.request("POST", "/api/v1/write", body=body, headers={
                "Content-Type": "application/x-protobuf", "Content-Encoding": "snappy",
                "X-Prometheus-Remote-Write-Version": "0.1.0"})
            response = connection.getresponse()
            response.read()
            statuses[response.status] += 1
    finally:
        connection.close()
    return {"bodies": len(bodies), "samples": samples_total, "bytes": sum(map(len, bodies)),
            "encode_seconds": encode_seconds, "send_seconds": time.perf_counter() - started,
            "statuses": {str(code): n for code, n in sorted(statuses.items())}}


def _proc_cpu_seconds(pid: int) -> float:
    """utime + stime of one process from /proc/<pid>/stat."""
    with open(f"/proc/{pid}/stat", "rb") as f:
        fields = f.read().rsplit(b")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


class FakeServers:
    """The ``cli`` phase's fake apiserver + Prometheus in a child process,
    stopped in ``close`` whatever happened."""

    def __init__(self, n_objects: int, samples: int, namespaces: int = 1):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._conn, child_conn = ctx.Pipe()
        self.proc = ctx.Process(target=_serve_fixture, args=(n_objects, samples, child_conn, namespaces),
                                daemon=True)
        self.proc.start()
        self._ready = None

    def ready(self) -> tuple[str, float, float]:
        """(url, series origin, fixture build seconds), waiting for the child."""
        if self._ready is None:
            check(self._conn.poll(timeout=600), "the fake-server child did not start within 600 s")
            port, origin, build_seconds = self._conn.recv()
            self._ready = (f"http://127.0.0.1:{port}", origin, build_seconds)
        return self._ready

    def counts(self) -> dict:
        """The fake apiserver's request counters (workload LISTs, pod LISTs
        and watch requests) and the fake Prometheus's request count, served
        so far."""
        self.ready()
        self._conn.send("counts")
        check(self._conn.poll(timeout=60), "the fake-server child did not report its counts")
        return self._conn.recv()

    def push(self, port: int, i0: int, i1: int) -> dict:
        """Have the child remote-write grid indices [i0, i1] of every series
        to the listener on ``port`` (`_remote_write`), and wait for its
        report. Blocking: an event loop serving the listener calls it
        through ``asyncio.to_thread``."""
        self.ready()
        self._conn.send(("push", port, i0, i1))
        check(self._conn.poll(timeout=600), "the fake-server child did not finish its remote-write")
        return self._conn.recv()

    def close(self) -> None:
        with contextlib.suppress(OSError):
            self._conn.send("done")
        self.proc.join(timeout=15)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout=15)


def _write_kubeconfig(path: str, url: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump({
            "current-context": "fake",
            "contexts": [{"name": "fake", "context": {"cluster": "fake", "user": "u"}}],
            "clusters": [{"name": "fake", "cluster": {"server": url}}],
            "users": [{"name": "u", "user": {"token": "t"}}],
        }, f)


def phase_cli(fakes: FakeServers) -> dict:
    import tempfile

    from krr_tpu_torch import main as cli

    url, origin, fixture_seconds = fakes.ready()
    cli.load_commands()
    scan_end = origin + (CLI_SAMPLES - 1) * CLI_STEP_SECONDS
    with tempfile.TemporaryDirectory(prefix="krr-cli-smoke-") as tmp:
        return _phase_cli(fakes, url, scan_end, fixture_seconds, os.path.join(tmp, "kubeconfig"))

#: The ``serve`` phase's windows on the ``cli`` fixture's 14 days of 15-minute
#: samples: a full 10-day tick at ``origin + 10 d``, then a delta tick 2 days
#: later; the cold control covers the 12-day union window in one tick.
SERVE_HISTORY_HOURS = 240
SERVE_DELTA_SECONDS = 2 * 86_400.0
#: Requests per read-path measurement (the median is printed with the list).
SERVE_READS = 5


async def _http(port: int, target: str, headers: "dict | None" = None) -> tuple[int, dict, bytes, float]:
    """One HTTP/1.1 GET over a fresh socket: status, headers, body and the
    request's wall in ms on the host clock."""
    started = time.perf_counter()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    lines = [f"GET {target} HTTP/1.1", "Host: localhost", "Connection: close"]
    lines += [f"{name}: {value}" for name, value in (headers or {}).items()]
    writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
    await writer.drain()
    data = await reader.read()
    ms = (time.perf_counter() - started) * 1e3
    writer.close()
    await writer.wait_closed()
    head, _, body = data.partition(b"\r\n\r\n")
    head_lines = head.decode("latin-1").split("\r\n")
    headers_out = dict(line.split(": ", 1) for line in head_lines[1:])
    return int(head_lines[0].split()[1]), headers_out, body, ms


def phase_serve(fakes: "FakeServers", smi: str, keep_dir: str) -> dict:
    """``serve`` (`krr_tpu_torch.server`) on the ``cli`` fixture: see the
    module docstring. Host code end to end — the phase holds every kernel's
    launch count at 0. The default server's journal is copied into
    ``keep_dir`` for the ``eval`` phase."""
    import shutil
    import tempfile

    url, origin, _fixture_seconds = fakes.ready()
    _reset_counts()
    with tempfile.TemporaryDirectory(prefix="krr-serve-smoke-") as tmp:
        kubeconfig = os.path.join(tmp, "kubeconfig")
        _write_kubeconfig(kubeconfig, url)
        report = asyncio.run(_phase_serve(url, origin, kubeconfig, tmp, fakes))
        report["journal_copy"] = shutil.copy(os.path.join(tmp, "default.journal"),
                                             os.path.join(keep_dir, "serve.journal"))
    launches, generic = _read_counts()
    check(not any(launches.values()) and not any(generic.values()),
          f"serve: a kernel launched during the phase: {launches} {generic}")
    report["launches"] = launches
    emit("serve", nvidia_smi=smi, **report)
    return report


async def _phase_serve(url: str, origin: float, kubeconfig: str, tmp: str, fakes: "FakeServers") -> dict:
    import numpy as np

    from krr_tpu_torch.core.config import Config
    from krr_tpu_torch.server.app import KrrServer

    t1 = origin + SERVE_HISTORY_HOURS * 3600.0
    t2 = t1 + SERVE_DELTA_SECONDS
    # The default device is the card: only a rehearsal without one names
    # the CPU.
    device_args = {} if DEVICE == "cuda" else {"device": DEVICE}

    def server(name: str, clock: list, *, hours: int = SERVE_HISTORY_HOURS, device: dict = device_args, **overrides):
        other_args = {"history_duration": hours, "timeframe_duration": int(CLI_STEP_SECONDS // 60),
                      "state_path": os.path.join(tmp, name), **device}
        config = Config(kubeconfig=kubeconfig, prometheus_url=url, strategy="tdigest", quiet=True,
                        server_port=0, other_args=other_args, **overrides)
        return KrrServer(config, clock=lambda: clock[0])

    async def ticks(ks, clock: list, at: "list[float]") -> list:
        """``run_once`` at each clock reading: each tick's wall and legs, and
        the fake server's CPU seconds over the tick (its first answer for a
        window renders the bodies; later answers come from its cache)."""
        out = []
        for now in at:
            clock[0] = now
            server_cpu = _proc_cpu_seconds(fakes.proc.pid)
            started = time.perf_counter()
            did_scan = await ks.scheduler.run_once()
            wall = time.perf_counter() - started
            server_cpu = _proc_cpu_seconds(fakes.proc.pid) - server_cpu
            check(did_scan is True, f"serve: the tick at {now} did not scan ({did_scan}): {ks.state.last_scan_error}")
            metrics = ks.state.metrics
            legs = {phase: metrics.value("krr_tpu_scan_duration_seconds", phase=phase)
                    for phase in ("discover", "fetch", "fold", "compute")}
            # A persist past the store's 16 MB compaction floor folds the WAL
            # into base shards: the timeline then records 0 appended bytes.
            out.append({"wall_seconds": wall, "legs_seconds": legs, "fake_server_cpu_seconds": server_cpu,
                        "wal_bytes": metrics.value("krr_tpu_store_wal_bytes"),
                        "compactions": metrics.value("krr_tpu_store_compactions_total")})
        return out

    def store_of(ks) -> dict:
        store = ks.state.store
        return {"keys": list(store.keys), **{f: getattr(store, f) for f in STORE_FIELDS}}

    report: dict = {"objects": CLI_OBJECTS, "history_hours": SERVE_HISTORY_HOURS,
                    "delta_seconds": SERVE_DELTA_SECONDS}

    # --- the equality run: --no-hysteresis, incremental == cold union window
    bodies, stores = {}, {}
    for name, device, hours, at in (
        ("incremental", device_args, SERVE_HISTORY_HOURS, [t1, t2]),
        ("cold", device_args, SERVE_HISTORY_HOURS + int(SERVE_DELTA_SECONDS // 3600), [t2]),
        ("incremental_cpu", {"device": "cpu"}, SERVE_HISTORY_HOURS, [t1, t2]),
    ):
        clock = [at[0]]
        ks = server(name, clock, hours=hours, device=device, hysteresis_enabled=False)
        check(ks.session.strategy.device.type == device.get("device", "cuda"),
              f"serve {name}: the strategy is bound to {ks.session.strategy.device}")
        await ks.start(run_scheduler=False)
        try:
            report[f"{name}_ticks"] = await ticks(ks, clock, at)
            status, _headers, body, _ms = await _http(ks.port, "/recommendations")
            check(status == 200, f"serve {name}: /recommendations answered {status}")
            bodies[name], stores[name] = body, store_of(ks)
            if name == "incremental":
                delta = ks.state.metrics.value("krr_tpu_fetch_window_seconds_total", kind="delta")
                check(delta == t2 - t1 - CLI_STEP_SECONDS,
                      f"serve: fetched a delta window of {delta} s, expected {t2 - t1 - CLI_STEP_SECONDS}")
        finally:
            await ks.shutdown()
    scans = json.loads(bodies["incremental"])["scans"]
    check(len(scans) == CLI_OBJECTS and b'"?"' not in bodies["incremental"],
          f"serve: {len(scans)} scans or an unknown value in the incremental server's body")
    check(bodies["incremental"] == bodies["cold"], "serve: incremental /recommendations != the cold union window's")
    check(same_store_bits(np, stores["incremental"], stores["cold"]),
          "serve: the incremental store arrays != the cold union window's")
    check(bodies["incremental_cpu"] == bodies["incremental"], "serve: the --device cpu server's bytes != the card's")
    report["body_bytes"] = len(bodies["incremental"])
    report["watch"] = await _serve_watch_leg(server, ticks, fakes, tmp, t1, t2, bodies["incremental"])

    # --- the default-config run: hysteresis, sentinel, savings, timeline
    clock = [t1]
    ks = server("default", clock)
    await ks.start(run_scheduler=False)
    try:
        report["default_ticks"] = await ticks(ks, clock, [t1, t2])
        records = ks.state.timeline.records()
        check(len(records) == 2, f"serve: {len(records)} timeline records after two ticks")
        for tick, record in zip(report["default_ticks"], records):
            tick["kind"] = record["kind"]
            tick["persist"] = record["persist"]
            tick["publish_seconds"] = record["categories"].get("publish")
        journal = ks.state.journal
        report["journal"] = {"records": journal.record_count, "bytes": journal.nbytes,
                             "file_bytes": os.path.getsize(journal.path)}
        port = ks.port
        reads: dict = {}

        async def timed_reads(name: str, target: str, headers=None, first_alone: bool = False) -> bytes:
            samples, body = [], b""
            for _ in range(SERVE_READS + int(first_alone)):
                status, got, body, ms = await _http(port, target, headers)
                check(status in (200, 304), f"serve: {target} answered {status}")
                samples.append(ms)
            if first_alone:
                reads[f"{name}_first_ms"] = samples.pop(0)
            reads[f"{name}_ms"] = samples
            reads[f"{name}_median_ms"] = statistics.median(samples)
            return body

        identity = await timed_reads("fast_path", "/recommendations")
        reads["body_bytes"] = len(identity)
        # A filtered json read renders on its first request (a cache miss)
        # and hits the response cache after.
        await timed_reads("filtered", "/recommendations?namespace=default", first_alone=True)
        gz = await timed_reads("gzip", "/recommendations", {"Accept-Encoding": "gzip"}, first_alone=True)
        reads["gzip_body_bytes"] = len(gz)
        import gzip as gzip_module

        check(gzip_module.decompress(gz) == identity, "serve: the gzip variant != the identity body")
        _status, headers, _body, _ms = await _http(port, "/recommendations")
        await timed_reads("revalidation_304", "/recommendations", {"If-None-Match": headers["ETag"]})
        await timed_reads("metrics", "/metrics")
        await timed_reads("statusz", "/statusz")
        report["reads"] = reads
        status, _headers, body, _ms = await _http(port, "/statusz")
        statusz = json.loads(body)
        check(status == 200 and "trend" in statusz and "savings" in statusz,
              f"serve: /statusz lacks trend or savings: {sorted(statusz)}")
        report["savings"] = statusz["savings"]
        before = identity
    finally:
        await ks.shutdown()

    # --- a restart inside one step: no fetch, the pre-restart bytes
    clock = [t2 + 60.0]
    started = time.perf_counter()
    ks = server("default", clock)
    report["reopen_seconds"] = time.perf_counter() - started
    await ks.start(run_scheduler=False)
    try:
        did_scan = await ks.scheduler.run_once()
        check(did_scan is False, f"serve: the restart's first tick returned {did_scan}, expected False")
        queries = ks.state.metrics.value("krr_tpu_prom_query_seconds_count", route="streamed") or 0.0
        queries += ks.state.metrics.value("krr_tpu_prom_query_seconds_count", route="buffered") or 0.0
        check(queries == 0, f"serve: the restart's first tick ran {queries} range queries")
        status, _headers, body, _ms = await _http(ks.port, "/recommendations")
        check(status == 200 and body == before, "serve: the restarted server's bytes != the pre-restart bytes")
        status, _headers, body, _ms = await _http(ks.port, "/healthz")
        check(status == 200 and json.loads(body)["status"] == "ok", f"serve: /healthz after restart: {body[:300]!r}")
        status, _headers, body, _ms = await _http(ks.port, "/debug/timeline")
        timeline = json.loads(body)
        check(status == 200 and len(timeline["records"]) == 2,
              f"serve: /debug/timeline holds {len(timeline.get('records', []))} records, expected 2")
        report["recovery_seconds"] = ks.state.metrics.value("krr_tpu_store_recovery_seconds")
    finally:
        await ks.shutdown()
    return report


async def _serve_watch_leg(server, ticks, fakes: "FakeServers", tmp: str, t1: float, t2: float,
                           relist_body: bytes) -> dict:
    """``--discovery-mode watch`` on the same ticks as the relist servers
    (``--no-hysteresis``): the watch server's bytes equal the relist
    server's; then a restart inside one step warm-starts the inventory from
    the derived snapshot with no LIST and serves the same bytes."""
    def discovery(metrics) -> dict:
        return {"relists": {reason: metrics.value("krr_tpu_discovery_relists_total", reason=reason)
                            for reason in ("seed", "410", "watch_error", "verify")},
                "watch_events": metrics.total("krr_tpu_discovery_watch_events_total"),
                "watch_restarts": metrics.total("krr_tpu_discovery_watch_restarts_total")}

    leg: dict = {}
    clock = [t1]
    ks = server("watch", clock, hysteresis_enabled=False, discovery_mode="watch")
    check(ks.config.discovery_snapshot_path == os.path.join(tmp, "watch", "discovery-inventory.json"),
          f"serve watch: the derived snapshot path is {ks.config.discovery_snapshot_path}")
    await ks.start(run_scheduler=False)
    try:
        before = fakes.counts()
        leg["ticks"] = await ticks(ks, clock, [t1, t2])
        after = fakes.counts()
        status, _headers, body, _ms = await _http(ks.port, "/recommendations")
        check(status == 200 and body == relist_body, "serve watch: /recommendations != the relist server's bytes")
        check(ks.state.discovery.get("mode") == "watch", f"serve watch: discovery {ks.state.discovery}")
        leg["seed_discover_seconds"] = leg["ticks"][0]["legs_seconds"]["discover"]
        leg["delta_discover_seconds"] = leg["ticks"][1]["legs_seconds"]["discover"]
        leg["requests"] = {k: after[k] - before[k] for k in after}
        leg["discovery"] = discovery(ks.state.metrics)
        check(leg["discovery"]["relists"]["seed"] == 1, f"serve watch: {leg['discovery']}")
    finally:
        await ks.shutdown()
    check(os.path.exists(ks.config.discovery_snapshot_path), "serve watch: no discovery snapshot after shutdown")
    leg["snapshot_bytes"] = os.path.getsize(ks.config.discovery_snapshot_path)

    clock = [t2 + 60.0]
    before = fakes.counts()
    ks = server("watch", clock, hysteresis_enabled=False, discovery_mode="watch")
    await ks.start(run_scheduler=False)
    try:
        started = time.perf_counter()
        did_scan = await ks.scheduler.run_once()
        leg["restart_tick_seconds"] = time.perf_counter() - started
        check(did_scan is False, f"serve watch: the restart's first tick returned {did_scan}")
        status, _headers, body, _ms = await _http(ks.port, "/recommendations")
        check(status == 200 and body == relist_body, "serve watch: the restarted server's bytes != the relist server's")
        leg["restart_discovery"] = discovery(ks.state.metrics)
    finally:
        await ks.shutdown()
    after = fakes.counts()
    leg["restart_requests"] = {k: after[k] - before[k] for k in after}
    check(leg["restart_requests"]["lists"] == 0 and leg["restart_requests"]["pod_lists"] == 0
          and not leg["restart_discovery"]["relists"]["seed"],
          f"serve watch: the restart relisted: {leg['restart_requests']} {leg['restart_discovery']}")
    return leg


#: The ``push`` phase's windows on the ``cli`` fixture's grid (900 s steps,
#: indices 0 … 1,343): the seed tick covers 10 days to index 960, the audit
#: tick the next 2 days (indices 961 … 1,152, pushed first), the steady tick
#: the rest (1,153 … 1,343). The audit runs on the first push-fed tick only.
PUSH_SEED_INDEX = SERVE_HISTORY_HOURS * 3600 // int(CLI_STEP_SECONDS)
PUSH_AUDIT_INDEX = PUSH_SEED_INDEX + int(SERVE_DELTA_SECONDS // CLI_STEP_SECONDS)
PUSH_VERIFY_SECONDS = 7 * 86_400.0


def _rss_bytes() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def phase_push(fakes: "FakeServers", smi: str) -> dict:
    """Push ingest (`krr_tpu_torch.ingest`, ``serve --metrics-mode push``)
    on the ``cli`` fixture: see the module docstring. Host code end to end,
    as in the JAX package — the phase holds every kernel's launch count
    at 0."""
    import tempfile

    import krr_tpu_torch.server.scheduler as scheduler_module

    url, origin, _fixture_seconds = fakes.ready()
    _reset_counts()
    # The snapshot's ``published_at`` (the ETag's millisecond stamp) reads
    # ``time.time()`` in the scheduler: pinned to the phase's clock, so the
    # push server's and the control's validators compare exactly.
    clock = [origin]
    real_time = scheduler_module.time
    scheduler_module.time = type("PinnedTime", (), {
        "time": staticmethod(lambda: clock[0]), "perf_counter": staticmethod(time.perf_counter),
        "monotonic": staticmethod(time.monotonic)})
    try:
        with tempfile.TemporaryDirectory(prefix="krr-push-smoke-") as tmp:
            kubeconfig = os.path.join(tmp, "kubeconfig")
            _write_kubeconfig(kubeconfig, url)
            report = asyncio.run(_phase_push(url, origin, kubeconfig, clock, fakes))
    finally:
        scheduler_module.time = real_time
    launches, generic = _read_counts()
    check(not any(launches.values()) and not any(generic.values()),
          f"push: a kernel launched during the phase: {launches} {generic}")
    report["launches"] = launches
    emit("push", nvidia_smi=smi, **report)
    return report


def _timed(store: list, fn):
    """``fn`` (a coroutine function or a plain one) appending each call's
    wall seconds to ``store``."""
    if inspect.iscoroutinefunction(fn):
        async def run_async(*args, **kwargs):
            started = time.perf_counter()
            try:
                return await fn(*args, **kwargs)
            finally:
                store.append(time.perf_counter() - started)

        return run_async

    def run(*args, **kwargs):
        started = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            store.append(time.perf_counter() - started)

    return run


async def _phase_push(url: str, origin: float, kubeconfig: str, clock: list, fakes: "FakeServers") -> dict:
    import numpy as np

    from krr_tpu_torch.core.config import Config
    from krr_tpu_torch.server.app import KrrServer

    started_phase = time.perf_counter()
    device_args = {} if DEVICE == "cuda" else {"device": DEVICE}
    ends = [origin + i * CLI_STEP_SECONDS for i in (PUSH_SEED_INDEX, PUSH_AUDIT_INDEX, CLI_SAMPLES - 1)]

    def server(**overrides):
        other_args = {"history_duration": SERVE_HISTORY_HOURS, "timeframe_duration": int(CLI_STEP_SECONDS // 60),
                      **device_args}
        config = Config(kubeconfig=kubeconfig, prometheus_url=url, strategy="tdigest", quiet=True,
                        server_port=0, hysteresis_enabled=False, other_args=other_args, **overrides)
        return KrrServer(config, clock=lambda: clock[0])

    rss_before = _rss_bytes()
    push = server(metrics_mode="push", ingest_port=0, ingest_verify_interval_seconds=PUSH_VERIFY_SECONDS)
    control = server()
    check(push.session.strategy.device.type == control.session.strategy.device.type == DEVICE,
          f"push: the strategies are bound to {push.session.strategy.device}, {control.session.strategy.device}")
    check(push.ingest is not None and control.ingest is None, "push: the servers' ingest planes are not as asked")
    plane = push.ingest
    # The push leg inside each push tick: the scheduler's fold (the plane's
    # fold, the audit when due, the prune) and the plane's fold alone.
    legs: dict = {"ingest_fold": [], "fold_fleet": []}
    push.scheduler._ingest_fold = _timed(legs["ingest_fold"], push.scheduler._ingest_fold)
    plane.fold_fleet = _timed(legs["fold_fleet"], plane.fold_fleet)

    def store_of(ks) -> dict:
        store = ks.state.store
        return {"keys": list(store.keys), **{f: getattr(store, f) for f in STORE_FIELDS}}

    async def tick(ks, at: float) -> dict:
        clock[0] = at
        before = fakes.counts()["prom_requests"]
        started = time.perf_counter()
        did_scan = await ks.scheduler.run_once()
        wall = time.perf_counter() - started
        check(did_scan is True, f"push: the tick at {at} did not scan ({did_scan}): {ks.state.last_scan_error}")
        records = ks.state.timeline.records() if ks.state.timeline is not None else []
        return {"wall_seconds": wall, "prom_requests": fakes.counts()["prom_requests"] - before,
                "ingest": dict(records[-1].get("ingest") or {}) if records else None}

    async def served(ks) -> tuple:
        status, headers, body, _ms = await _http(ks.port, "/recommendations")
        check(status == 200, f"push: /recommendations answered {status}")
        return body, headers["ETag"], headers["X-KRR-Epoch"]

    async def compare(label: str) -> None:
        check(same_store_bits(np, store_of(push), store_of(control)),
              f"push {label}: the push server's store != the pull control's")
        mine, theirs = await served(push), await served(control)
        check(mine[0] == theirs[0], f"push {label}: /recommendations bytes != the pull control's")
        check(mine[1:] == theirs[1:], f"push {label}: ETag/epoch {mine[1:]} != the pull control's {theirs[1:]}")

    async def remote_write(i0: int, i1: int) -> dict:
        samples_before = push.state.metrics.value("krr_tpu_ingest_samples_total") or 0.0
        # The child POSTs while this loop serves the listener: a blocking
        # recv here would deadlock.
        sent = await asyncio.to_thread(fakes.push, push.ingest_listener.port, i0, i1)
        accepted = (push.state.metrics.value("krr_tpu_ingest_samples_total") or 0.0) - samples_before
        check(sent["statuses"] == {"204": sent["bodies"]}, f"push: the listener answered {sent['statuses']}")
        check(accepted == sent["samples"], f"push: {accepted} samples accepted of {sent['samples']} sent")
        sent["accepted_samples"] = accepted
        sent["accepted_samples_per_second"] = accepted / sent["send_seconds"]
        sent["bodies_per_second"] = sent["bodies"] / sent["send_seconds"]
        sent["wire_bytes_per_sample"] = sent["bytes"] / sent["samples"]
        return sent

    report: dict = {"objects": CLI_OBJECTS, "series": 2 * CLI_OBJECTS, "history_hours": SERVE_HISTORY_HOURS,
                    "samples_per_body": PUSH_SAMPLES_PER_BODY}
    await push.start(run_scheduler=False)
    await control.start(run_scheduler=False)
    try:
        seed = {"push": await tick(push, ends[0]), "control": await tick(control, ends[0])}
        check((seed["push"]["ingest"] or {}).get("push_objects") == 0, f"push seed: {seed['push']['ingest']}")
        await compare("seed")
        report["rss_after_seed_bytes"] = _rss_bytes()

        report["audit_window"] = await remote_write(PUSH_SEED_INDEX + 1, PUSH_AUDIT_INDEX)
        audit = {"push": await tick(push, ends[1]), "control": await tick(control, ends[1])}
        ingest = audit["push"]["ingest"] or {}
        check(ingest.get("push_objects") == CLI_OBJECTS, f"push audit tick: {ingest.get('push_objects')} push objects")
        check(ingest.get("verify") == {"audited": CLI_OBJECTS, "divergent": 0}, f"push audit: {ingest.get('verify')}")
        await compare("audit")

        report["steady_window"] = await remote_write(PUSH_AUDIT_INDEX + 1, CLI_SAMPLES - 1)
        steady = {"push": await tick(push, ends[2]), "control": await tick(control, ends[2])}
        ingest = steady["push"]["ingest"] or {}
        check(ingest.get("push_objects") == CLI_OBJECTS, f"push steady tick: {ingest.get('push_objects')} push objects")
        check(ingest.get("verify") is None, f"push steady tick audited: {ingest.get('verify')}")
        check(steady["push"]["prom_requests"] == 0,
              f"push: the steady tick sent Prometheus {steady['push']['prom_requests']} requests")
        await compare("steady")
        stats = plane.stats()
        check(stats["rejected"] == {} and stats["decode_errors_total"] == 0 and stats["tombstones_total"] == 0,
              f"push: samples rejected or bodies refused: {stats}")
        report["rss_after_steady_bytes"] = _rss_bytes()
        report["rss_growth_bytes"] = report["rss_after_steady_bytes"] - rss_before
        report["ticks"] = {"seed": seed, "audit": audit, "steady": steady}
        report["ingest_fold_seconds"] = legs["ingest_fold"]
        report["fold_fleet_seconds"] = legs["fold_fleet"]
        report["plane"] = {k: stats[k] for k in ("series", "buffered_samples", "samples_total", "bodies_total",
                                                  "bytes_total")}
        report["buffered_samples_after_prune"] = ingest["buffered_samples"]
        report["freshness_seconds"] = ingest["freshness_seconds"]
        report["verify_total"] = push.state.metrics.value("krr_tpu_ingest_verify_total")
        report["push_objects_total"] = push.state.metrics.value("krr_tpu_ingest_push_objects_total")
    finally:
        await push.shutdown()
        await control.shutdown()
    report["wall_seconds"] = time.perf_counter() - started_phase
    return report


#: The ``eval`` phase: replay ticks, the launches each strategy's replay must
#: make (one ``run_batch`` a tick: ``simple`` K1 + K2, ``tdigest`` K3 + K2),
#: and the rtol of the ``--device cpu`` run's and the numpy oracle's slacks.
EVAL_TICKS = 16
EVAL_LAUNCHES = {"bisect_select": EVAL_TICKS, "row_max": 2 * EVAL_TICKS, "digest_hist": EVAL_TICKS,
                 "topk_select": 0, "radix_digit_hist": 0}
EVAL_RTOL = 1e-9
EVAL_SLACKS = ("overprovisioned_core_hours", "overprovisioned_gb_hours")


#: The ``federation`` phase's fleet: the ``cli`` shape (10,000 one-pod
#: Deployments, 1,344 samples at 15 minutes) over four namespaces, one
#: scanner shard each. Its first round covers the default 14-day window at
#: ``origin + 12 d``; the second is the delta to the fixture's last sample.
FED_OBJECTS = 10_000
FED_NAMESPACES = 4
FED_FIRST_DAYS = 12
#: Replica reads per measurement (the median is printed with the list).
FED_READS = 5


def _stores_equal_by_key(np, a, b) -> bool:
    """Two digest stores hold the same keys and, row for row by key, the
    same bits in every array (the aggregator grows rows in shard-arrival
    order, a single-process scan in discovery order)."""
    if sorted(a.keys) != sorted(b.keys):
        return False
    index = {key: i for i, key in enumerate(b.keys)}
    order = np.asarray([index[key] for key in a.keys], dtype=np.int64)
    return all(
        np.array_equal(getattr(a, f).view(np.uint32), getattr(b, f)[order].view(np.uint32))
        for f in STORE_FIELDS
    )


def phase_federation(fakes: "FakeServers", smi: str) -> dict:
    """Federation (`krr_tpu_torch.federation`) on its own fixture: see the
    module docstring. Host code end to end — the phase holds every kernel's
    launch count at 0."""
    import tempfile

    import krr_tpu_torch.server.scheduler as scheduler_module

    url, origin, fixture_seconds = fakes.ready()
    _reset_counts()
    # The snapshot's ``published_at`` (the ETag's millisecond stamp) reads
    # ``time.time()`` in the scheduler: pinned to the phase's clock, so the
    # aggregator's and the control's validators compare exactly.
    clock = [origin]
    real_time = scheduler_module.time
    scheduler_module.time = type("PinnedTime", (), {
        "time": staticmethod(lambda: clock[0]), "perf_counter": staticmethod(time.perf_counter),
        "monotonic": staticmethod(time.monotonic)})
    try:
        with tempfile.TemporaryDirectory(prefix="krr-federation-smoke-") as tmp:
            kubeconfig = os.path.join(tmp, "kubeconfig")
            _write_kubeconfig(kubeconfig, url)
            report = asyncio.run(_phase_federation(url, origin, kubeconfig, tmp, clock))
    finally:
        scheduler_module.time = real_time
    report["fixture_seconds"] = fixture_seconds
    launches, generic = _read_counts()
    check(not any(launches.values()) and not any(generic.values()),
          f"federation: a kernel launched during the phase: {launches} {generic}")
    report["launches"] = launches
    emit("federation", nvidia_smi=smi, **report)
    return report


async def _phase_federation(url: str, origin: float, kubeconfig: str, tmp: str, clock: list) -> dict:
    import numpy as np
    from click.testing import CliRunner

    from krr_tpu_torch import main as cli
    from krr_tpu_torch.core.config import Config
    from krr_tpu_torch.federation.replica import ReplicaServer
    from krr_tpu_torch.federation.shard import FederatedShard
    from krr_tpu_torch.server.app import KrrServer

    started = time.perf_counter()
    t1 = origin + FED_FIRST_DAYS * 86_400.0
    t2 = origin + (CLI_SAMPLES - 1) * CLI_STEP_SECONDS
    namespaces = [f"ns-{k}" for k in range(FED_NAMESPACES)]
    device = {} if DEVICE == "cuda" else {"device": DEVICE}
    other_args = {"timeframe_duration": int(CLI_STEP_SECONDS // 60), **device}

    def config(**overrides) -> "Config":
        extra = overrides.pop("other_args", {})
        # --no-hysteresis: every recompute publishes, so the delta round
        # moves the epoch and the replica's broadcast install is measured.
        return Config(kubeconfig=kubeconfig, prometheus_url=url, strategy="tdigest", quiet=True,
                      server_port=0, hysteresis_enabled=False, other_args={**other_args, **extra}, **overrides)

    report: dict = {"objects": FED_OBJECTS, "namespaces": FED_NAMESPACES,
                    "window_seconds": [t1 - origin, t2 - t1]}

    # --- the control: one single-process serve over the whole fleet
    control = KrrServer(config(other_args={"state_path": os.path.join(tmp, "control")}), clock=lambda: clock[0])
    check(control.session.strategy.device.type == device.get("device", "cuda"),
          f"federation: the control is bound to {control.session.strategy.device}")
    await control.start(run_scheduler=False)
    aggregator = shards = replica = None
    try:
        control_ticks = []
        for now in (t1, t2):
            clock[0] = now
            tick_started = time.perf_counter()
            check(await control.scheduler.run_once() is True,
                  f"federation: the control's tick at {now} did not scan: {control.state.last_scan_error}")
            control_ticks.append(time.perf_counter() - tick_started)
        report["control_tick_seconds"] = control_ticks
        _status, control_headers, control_body, _ms = await _http(control.port, "/recommendations")

        # --- the aggregator and one shard a namespace
        clock[0] = t1
        aggregator = KrrServer(
            config(federation_listen="127.0.0.1:0", other_args={"state_path": os.path.join(tmp, "aggregator")}),
            clock=lambda: clock[0])
        await aggregator.start(run_scheduler=False)
        agg = aggregator.aggregator
        shards = [
            FederatedShard(config(namespaces=[ns], federation_aggregator=f"127.0.0.1:{agg.port}"),
                           clock=lambda: clock[0], shard_id=ns)
            for ns in namespaces
        ]
        for shard in shards:
            check(shard.session.strategy.device.type == device.get("device", "cuda"),
                  f"federation: shard {shard.shard_id} is bound to {shard.session.strategy.device}")
        legs: dict = {}

        def timed_method(shard, name: str) -> None:
            inner = getattr(shard, name)

            async def wrapper(*args, **kwargs):
                leg_started = time.perf_counter()
                try:
                    return await inner(*args, **kwargs)
                finally:
                    key = (shard.shard_id, name)
                    legs[key] = legs.get(key, 0.0) + time.perf_counter() - leg_started
            setattr(shard, name, wrapper)

        for shard in shards:
            for name in ("_discover", "_encode_tick", "_pump"):
                timed_method(shard, name)
        # The replica's install latency: from the aggregator's broadcast of
        # a published epoch to the end of the replica's install of it.
        marks: dict = {}
        broadcast = agg.broadcast_epoch

        async def marked_broadcast():
            marks["broadcast"] = time.perf_counter()
            return await broadcast()
        agg.broadcast_epoch = marked_broadcast

        async def round_(now: float, cut: "FederatedShard | None" = None) -> dict:
            """Every shard ticks (timed and split), the aggregator enqueues,
            optionally one shard's uplink is cut and restored before the
            aggregate tick (its re-send is a duplicate), one aggregate tick
            applies and publishes, the acks flow back."""
            clock[0] = now
            legs.clear()
            sent_before = {s.shard_id: s.metrics.total("krr_tpu_federation_sent_bytes_total") or 0.0
                           for s in shards}
            ticks = {}
            for shard in shards:
                tick_started = time.perf_counter()
                check(await shard.tick(now) is True, f"federation: shard {shard.shard_id} did not scan at {now}")
                wall = time.perf_counter() - tick_started
                discover = legs.get((shard.shard_id, "_discover"), 0.0)
                encode = legs.get((shard.shard_id, "_encode_tick"), 0.0)
                send = legs.get((shard.shard_id, "_pump"), 0.0)
                ticks[shard.shard_id] = {
                    "wall_seconds": wall, "discover_seconds": discover, "encode_seconds": encode,
                    "send_seconds": send, "fetch_fold_seconds": wall - discover - encode - send,
                    "wire_bytes": (shard.metrics.total("krr_tpu_federation_sent_bytes_total") or 0.0)
                    - sent_before[shard.shard_id],
                }
            deadline = time.monotonic() + 120.0
            while not all(s.shard_id in agg._shards and agg._shards[s.shard_id].enqueued >= s.epoch
                          for s in shards):
                check(time.monotonic() < deadline, "federation: the aggregator did not enqueue every shard's tick")
                await asyncio.sleep(0.005)
            out: dict = {"shards": ticks}
            if cut is not None:
                duplicates = agg._shards[cut.shard_id].duplicates
                cut._disconnect()
                await cut._pump()  # reconnect: WELCOME acks the applied epoch, the tick re-sends
                while agg._shards[cut.shard_id].duplicates == duplicates:
                    check(time.monotonic() < deadline, "federation: the re-sent record was not discarded")
                    await asyncio.sleep(0.005)
                out["cut"] = {"shard": cut.shard_id,
                              "duplicates": agg._shards[cut.shard_id].duplicates - duplicates,
                              "duplicate_metric": aggregator.state.metrics.value(
                                  "krr_tpu_federation_duplicate_records_total", shard=cut.shard_id)}
            installed = replica.client.installed if replica is not None else None
            if installed is not None:
                installed.clear()
            epoch_before = aggregator.state.publish_epoch
            tick_started = time.perf_counter()
            check(await aggregator.scheduler.run_once() is True, "federation: the aggregate tick did not publish")
            published = time.perf_counter()
            metrics = aggregator.state.metrics
            record = aggregator.state.timeline.records()[-1]
            check(record["kind"] == "aggregate", f"federation: the newest timeline record is {record['kind']}")
            out["aggregate"] = {
                "wall_seconds": published - tick_started,
                "apply_seconds": metrics.value("krr_tpu_scan_duration_seconds", phase="fold"),
                "publish_seconds": metrics.value("krr_tpu_scan_duration_seconds", phase="compute"),
                "persist": record.get("persist"),
                "applied_records": record["federation"]["applied_records"],
                "wire_bytes": record["federation"]["wire_bytes"],
            }
            if installed is not None:
                check(aggregator.state.publish_epoch > epoch_before,
                      "federation: the delta round did not move the published epoch")
                await asyncio.wait_for(installed.wait(), timeout=60.0)
                out["replica_install_ms"] = (marks["installed"] - marks["broadcast"]) * 1e3
            for shard in shards:
                check(await shard.wait_acked(shard.epoch, timeout=60.0),
                      f"federation: shard {shard.shard_id} was not acked past {shard.acked}")
            return out

        report["round_full"] = await round_(t1)
        # --- a replica subscribed after the first publish: its catch-up frame
        replica = ReplicaServer(Config(federation_aggregator=f"127.0.0.1:{agg.port}",
                                       federation_shard_id="replica-0", server_port=0, quiet=True),
                                clock=lambda: clock[0])
        await replica.start()
        install = replica.client._install

        async def marked_install(*args, **kwargs):
            try:
                return await install(*args, **kwargs)
            finally:
                marks["installed"] = time.perf_counter()
        replica.client._install = marked_install
        deadline = time.monotonic() + 60.0
        while replica.state.publish_epoch != aggregator.state.publish_epoch:
            check(time.monotonic() < deadline, "federation: the replica did not install the catch-up epoch")
            await asyncio.sleep(0.005)
        report["round_delta"] = await round_(t2, cut=shards[0])
        cut = report["round_delta"]["cut"]
        check(cut["duplicates"] == 1 and cut["duplicate_metric"] == 1.0,
              f"federation: the cut uplink's re-send counted {cut}")

        # --- the merged view against the control
        check(len(aggregator.state.store.keys) == FED_OBJECTS,
              f"federation: the aggregator holds {len(aggregator.state.store.keys)} rows")
        check(_stores_equal_by_key(np, aggregator.state.store, control.state.store),
              "federation: the aggregator's store != the control's, by key")
        _status, agg_headers, agg_body, _ms = await _http(aggregator.port, "/recommendations")
        check(agg_body == control_body, "federation: the aggregator's /recommendations != the control's")
        for name in ("ETag", "X-KRR-Epoch", "Last-Modified"):
            check(agg_headers.get(name) == control_headers.get(name),
                  f"federation: {name} {agg_headers.get(name)} != the control's {control_headers.get(name)}")
        scans = json.loads(agg_body)["scans"]
        check(len(scans) == FED_OBJECTS and b'"?"' not in agg_body,
              f"federation: {len(scans)} scans or an unknown value in the aggregator's body")
        report["body_bytes"] = len(agg_body)

        # --- the replica: the source's bytes and validators
        deadline = time.monotonic() + 60.0
        while replica.state.publish_epoch != aggregator.state.publish_epoch:
            check(time.monotonic() < deadline, "federation: the replica did not follow the broadcast")
            await asyncio.sleep(0.005)
        reads: dict = {}
        for name, headers in (("identity", None), ("gzip", {"Accept-Encoding": "gzip"})):
            src = await _http(aggregator.port, "/recommendations", headers)
            samples = []
            for _ in range(FED_READS):
                status, got_headers, body, ms = await _http(replica.port, "/recommendations", headers)
                check(status == 200 and body == src[2], f"federation: the replica's {name} body != the source's")
                for header in ("ETag", "X-KRR-Epoch", "Last-Modified", "Content-Encoding", "Content-Length"):
                    check(got_headers.get(header) == src[1].get(header),
                          f"federation: the replica's {header} != the source's")
                samples.append(ms)
            reads[f"{name}_ms"] = samples
            reads[f"{name}_median_ms"] = statistics.median(samples)
        samples = []
        for _ in range(FED_READS):
            status, _h, body, ms = await _http(replica.port, "/recommendations", {"If-None-Match": agg_headers["ETag"]})
            check(status == 304 and body == b"", f"federation: the replica answered {status} to the source's ETag")
            samples.append(ms)
        reads["conditional_304_ms"] = samples
        reads["conditional_304_median_ms"] = statistics.median(samples)
        report["replica_reads"] = reads

        # --- fleet-status: the census lists the four shards and the replica
        cli.load_commands()
        result = await asyncio.to_thread(
            CliRunner().invoke, cli.app, ["fleet-status", "--url", f"http://127.0.0.1:{aggregator.port}", "-f", "json"])
        check(result.exit_code == 0, f"federation: fleet-status exited {result.exit_code}: {result.output[-500:]}")
        census = json.loads(result.output)
        roles: dict = {}
        for node in census["nodes"]:
            roles.setdefault(node["role"], []).append(node["node"])
        check(sorted(roles.get("shard", [])) == namespaces and roles.get("replica") == ["replica-0"],
              f"federation: fleet-status lists {roles}")
        report["census"] = {role: len(nodes) for role, nodes in roles.items()}
    finally:
        if replica is not None:
            await replica.shutdown()
        for shard in shards or []:
            await shard.close()
        if aggregator is not None:
            await aggregator.shutdown()
        await control.shutdown()
    report["wall_seconds"] = time.perf_counter() - started
    return report


def eval_grid(np, origin: float):
    """The ``cli`` fixture's usage grid at its own shape (10,000 × 1,344 at
    15 minutes): the same generator, seed and draw order as
    ``_serve_fixture``, one row per Deployment under its object key."""
    from krr_tpu_torch.eval import ReplayInput

    rng = np.random.default_rng(5)
    cpu = np.empty((CLI_OBJECTS, CLI_SAMPLES))
    mem = np.empty((CLI_OBJECTS, CLI_SAMPLES))
    for i in range(CLI_OBJECTS):
        cpu[i] = np.round(rng.gamma(2.0, 0.05, CLI_SAMPLES), 4)
        mem[i] = np.floor(rng.uniform(5e7, 4e8, CLI_SAMPLES) / 4096) * 4096
    keys = [f"fake/default/wl-{i}/main/Deployment" for i in range(CLI_OBJECTS)]
    return ReplayInput.from_series({k: (cpu[i], mem[i]) for i, k in enumerate(keys)},
                                   origin + CLI_STEP_SECONDS * np.arange(CLI_SAMPLES))


def oracle_scores(np, inputs, replayed) -> dict:
    """``score_grids`` in numpy: float32 comparisons and terms as the JAX
    package computes them, the terms summed in float64."""
    from krr_tpu_torch.eval import expand_ticks

    step_hours = inputs.step_seconds / 3600.0
    out = {}
    for usage, rec, incidents, slack, scale in (
        (inputs.cpu, replayed.rec_cpu, "throttle_incidents", "overprovisioned_core_hours", 1.0),
        (inputs.mem, replayed.rec_mem, "oom_incidents", "overprovisioned_gb_hours", 1e9),
    ):
        full, mask_ticks = expand_ticks(replayed.tick_indices, rec, usage.shape[1])
        mask = mask_ticks[None, :] & np.isfinite(usage) & np.isfinite(full)
        u = np.nan_to_num(usage).astype(np.float32)
        r = np.nan_to_num(full).astype(np.float32)
        exceed = (u > r) & mask
        edges = exceed.copy()
        edges[:, 1:] &= ~exceed[:, :-1]
        out[incidents] = int(np.count_nonzero(edges))
        covered = mask & ~exceed
        out[slack] = float(np.sum((r - u)[covered], dtype=np.float64)) * step_hours / scale
    return out


def phase_eval(torch, np, smi: str, journal: "str | None") -> dict:
    """``eval`` (`krr_tpu_torch.eval`) through the port's click command: see
    the module docstring."""
    import tempfile

    from click.testing import CliRunner

    import krr_tpu_torch.eval as eval_module
    from krr_tpu_torch import main as cli
    from krr_tpu_torch.eval import score as score_module
    from krr_tpu_torch.obs.device import DeviceObs
    from krr_tpu_torch.obs.trace import Tracer
    from tests.fakes.servers import FakeBackend

    ends = eval_module.tick_ends(CLI_SAMPLES, EVAL_TICKS)
    check(len(ends) == EVAL_TICKS and len(set(ends.tolist())) == EVAL_TICKS,
          f"eval: tick_ends({CLI_SAMPLES}, {EVAL_TICKS}) = {ends.tolist()}")
    cli.load_commands()
    report: dict = {"workloads": CLI_OBJECTS, "samples": CLI_SAMPLES, "ticks": EVAL_TICKS, "tick_ends": ends.tolist()}
    started = time.perf_counter()
    inputs = eval_grid(np, FakeBackend.SERIES_ORIGIN)
    report["grid_seconds"] = time.perf_counter() - started

    replays: dict = {}
    scoring: dict = {}
    replay, score_replay, reduce = eval_module.replay, eval_module.score_replay, score_module._reduce

    def recording_replay(inputs_, strategy, **kwargs):
        """``replay``, keeping its series and wall, and the strategy's
        stages summed over its ``run_batch`` calls (each call the
        ``compute`` span of a recording tracer)."""
        tracer = Tracer(ring_scans=1_000_000)
        strategy.obs = DeviceObs(tracer)
        run_batch = strategy.run_batch

        def traced_run_batch(batch):
            with tracer.span("compute"):
                return run_batch(batch)

        strategy.run_batch = traced_run_batch
        started = time.perf_counter()
        out = replay(inputs_, strategy, **kwargs)
        wall = time.perf_counter() - started
        legs: dict = {}
        for spans in tracer.traces():
            for span in spans:
                if span.parent_id is not None:
                    legs[span.name] = legs.get(span.name, 0.0) + span.duration
        replays[out.strategy] = {"series": out, "wall_seconds": wall, "legs": legs}
        return out

    def timed_score_replay(inputs_, replayed, **kwargs):
        """``score_replay``'s wall, and its two device reduces' (the float32
        casts, the copies to the device and the reduce, synchronised by the
        readback); the rest is the host prelude."""
        reduce_seconds = []

        def timed_reduce(*args):
            started = time.perf_counter()
            out = reduce(*args)
            reduce_seconds.append(time.perf_counter() - started)
            return out

        score_module._reduce = timed_reduce
        try:
            started = time.perf_counter()
            row = score_replay(inputs_, replayed, **kwargs)
            scoring[replayed.strategy] = (time.perf_counter() - started, sum(reduce_seconds))
        finally:
            score_module._reduce = reduce
        return row

    def invoke(args: list, device: "str | None" = None) -> tuple[str, float]:
        replays.clear()
        scoring.clear()
        # The default device is the card: only a rehearsal without one
        # names the CPU.
        device = device or (None if DEVICE == "cuda" else DEVICE)
        argv = ["eval", *args, "-f", "json", "-q", *(["--device", device] if device else [])]
        eval_module.replay, eval_module.score_replay = recording_replay, timed_score_replay
        try:
            started = time.perf_counter()
            result = CliRunner().invoke(cli.app, argv, catch_exceptions=False)
            wall = time.perf_counter() - started
        finally:
            eval_module.replay, eval_module.score_replay = replay, score_replay
        check(result.exit_code == 0, f"eval {args} exited {result.exit_code}: {result.output[-2000:]}")
        return result.output, wall

    with tempfile.TemporaryDirectory(prefix="krr-eval-smoke-") as tmp:
        npz = os.path.join(tmp, "usage.npz")
        inputs.save_npz(npz)
        usage = ["--usage", npz, "--strategy", "simple", "--strategy", "tdigest"]

        # --- the card: the default device, launches counted
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        card_json, wall = invoke(usage)
        launches, generic = _read_counts()
        # The plain versions launch nothing: a rehearsal on the CPU counts 0.
        expected = EVAL_LAUNCHES if DEVICE == "cuda" else dict.fromkeys(EVAL_LAUNCHES, 0)
        check(launches == expected and not any(generic.values()),
              f"eval: launches {launches} (expected {expected}), generic folds {generic}")
        report["launches"] = launches
        report["wall_seconds"] = wall
        report["peak_device_bytes"] = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else None
        card_series = {name: r["series"] for name, r in replays.items()}
        legs = {}
        for name, r in replays.items():
            seconds = r["series"].extra["seconds"]
            legs[name] = {"replay_seconds": r["wall_seconds"], **{f"{k}_seconds": v for k, v in seconds.items()},
                          "run_batch_legs_seconds": r["legs"],
                          "score_seconds": scoring[name][0], "score_reduce_seconds": scoring[name][1],
                          "rows_per_second": CLI_OBJECTS * EVAL_TICKS / r["wall_seconds"]}
        report["strategies"] = legs
        board = json.loads(card_json)
        check(board["workloads"] == CLI_OBJECTS and len(board["scores"]) == 2,
              f"eval: the board has {board['workloads']} workloads, {len(board['scores'])} rows")
        for row in board["scores"]:
            check(row["ticks"] == EVAL_TICKS and row["samples_scored"] == CLI_SAMPLES - int(ends[0]),
                  f"eval: {row['strategy']} scored {row['ticks']} ticks, {row['samples_scored']} samples")
        report["board"] = board["scores"]

        # --- the same replay again on the card: byte-identical
        again, report["repeat_wall_seconds"] = invoke(usage)
        check(again == card_json, "eval: two replays on the card rendered different bytes")

        # --- the numpy oracle over the card's replayed series
        for row in board["scores"]:
            oracle = oracle_scores(np, inputs, card_series[row["strategy"]])
            for field in ("oom_incidents", "throttle_incidents"):
                check(row[field] == oracle[field], f"eval {row['strategy']}: {field} {row[field]} vs the oracle's {oracle[field]}")
            for field in EVAL_SLACKS:
                check(abs(row[field] - oracle[field]) <= max(EVAL_RTOL * abs(oracle[field]), 1e-6),
                      f"eval {row['strategy']}: {field} {row[field]} vs the oracle's {oracle[field]}")
            report.setdefault("oracle", {})[row["strategy"]] = oracle

        # --- the plain versions on the CPU
        cpu_json, report["cpu_wall_seconds"] = invoke(usage, device="cpu")
        cpu_board = json.loads(cpu_json)
        check([r["strategy"] for r in cpu_board["scores"]] == [r["strategy"] for r in board["scores"]],
              "eval: the --device cpu board's order differs from the card's")
        for card_row, cpu_row in zip(board["scores"], cpu_board["scores"]):
            for field in ("oom_incidents", "throttle_incidents", "flaps", "ticks", "samples_scored", "workloads"):
                check(card_row[field] == cpu_row[field],
                      f"eval {card_row['strategy']}: {field} {card_row[field]} on the card, {cpu_row[field]} on the CPU")
            for field in EVAL_SLACKS:
                check(abs(card_row[field] - cpu_row[field]) <= max(EVAL_RTOL * abs(cpu_row[field]), 1e-6),
                      f"eval {card_row['strategy']}: {field} {card_row[field]} on the card, {cpu_row[field]} on the CPU")
        report["cpu_differing_bytes"] = sum(a != b for a, b in zip(card_json, cpu_json)) + abs(len(card_json) - len(cpu_json))
        report["cpu_series_equal"] = {
            name: bool(np.array_equal(card_series[name].rec_cpu, replays[name]["series"].rec_cpu)
                       and np.array_equal(card_series[name].rec_mem, replays[name]["series"].rec_mem))
            for name in card_series
        }

        # --- the scoring reduce alone on the card at the grid's shape
        full, mask_ticks = score_module.expand_ticks(ends, card_series["simple"].rec_mem, CLI_SAMPLES)
        mask = mask_ticks[None, :] & np.isfinite(inputs.mem) & np.isfinite(full)
        device_args = [torch.from_numpy(np.ascontiguousarray(a, t)).to(DEVICE) for a, t in
                       ((np.nan_to_num(inputs.mem), np.float32), (np.nan_to_num(full), np.float32), (mask, bool))]
        report["reduce_ms"] = cuda_ms(torch, lambda: score_module.reduce_grid(*device_args), warmup=2, runs=5)

    # --- the serve phase's journal
    if journal is not None:
        _reset_counts()
        journal_json, wall = invoke(["--journal", journal])
        journal_board = json.loads(journal_json)
        check(journal_board["workloads"] == CLI_OBJECTS, f"eval --journal: {journal_board['workloads']} workloads")
        report["journal"] = {"wall_seconds": wall, "workloads": journal_board["workloads"],
                             "samples": journal_board["samples"],
                             "rows": {r["strategy"]: r["workloads"] * r["ticks"] for r in journal_board["scores"]},
                             "launches": _read_counts()[0]}
    emit("eval", nvidia_smi=smi, **report)
    return report


def _phase_cli(fakes: FakeServers, url: str, scan_end: float, fixture_seconds: float, kubeconfig: str) -> dict:
    from click.testing import CliRunner

    from krr_tpu_torch import main as cli
    from krr_tpu_torch.core import runner as runner_module
    from krr_tpu_torch.integrations import native
    from krr_tpu_torch.integrations.prometheus import TRANSPORT_PHASES
    from krr_tpu_torch.obs.trace import Tracer

    _write_kubeconfig(kubeconfig, url)
    common = ["--kubeconfig", kubeconfig, "-p", url, "-q", "-f", "json", "--scan-end-timestamp", repr(scan_end)]

    captured: list = []

    class CapturingRunner(runner_module.Runner):
        """The CLI's own Runner under a recording tracer, remembered so its
        stats and stages can be read."""

        def __init__(self, *args, **kwargs):
            kwargs.setdefault("tracer", Tracer())
            super().__init__(*args, **kwargs)
            captured.append(self)

    def invoke(args: list) -> tuple[str, dict, float]:
        try:
            click_runner = CliRunner(mix_stderr=False)
        except TypeError:  # click >= 8.2 keeps stderr apart already
            click_runner = CliRunner()
        captured.clear()
        original = runner_module.Runner
        runner_module.Runner = CapturingRunner
        try:
            server_cpu = _proc_cpu_seconds(fakes.proc.pid)
            started = time.perf_counter()
            result = click_runner.invoke(cli.app, args, catch_exceptions=False)
            wall = time.perf_counter() - started
            server_cpu = _proc_cpu_seconds(fakes.proc.pid) - server_cpu
        finally:
            runner_module.Runner = original
        check(result.exit_code == 0, f"cli {args[:3]} exited {result.exit_code}: {result.stdout[-2000:]}")
        runner = captured[-1]
        stats = {
            **runner.stats,
            # The compute leg split by its stages.
            "strategy_legs_seconds": stage_legs(runner),
            "store_stats": getattr(runner.session.strategy, "store_stats", None),
            "server_cpu_seconds": server_cpu,
            "streamed_queries": runner.metrics.value("krr_tpu_prom_query_seconds_count", route="streamed") or 0.0,
            "buffered_queries": runner.metrics.value("krr_tpu_prom_query_seconds_count", route="buffered") or 0.0,
            # Per-query transport phases summed over the scan's range
            # queries (concurrent queries overlap, so the sums may pass
            # the fetch wall).
            "prom_phase_seconds": {
                phase: runner.metrics.value("krr_tpu_prom_phase_seconds_sum", phase=phase) or 0.0
                for phase in TRANSPORT_PHASES
            },
        }
        return result.stdout, stats, wall

    paths = {
        "simple": (["simple"], {"bisect_select", "row_max"}),
        "tdigest": (["tdigest"], {"digest_hist", "row_max"}),
        "tdigest_exact": (["tdigest", "--exact_upgrade", "true"], {"topk_select", "row_max"}),
    }
    report = {
        "objects": CLI_OBJECTS, "samples_per_object": CLI_SAMPLES, "step_seconds": CLI_STEP_SECONDS,
        "fixture_build_seconds": fixture_seconds, "paths": {},
    }
    rendered = {}
    for path, (command, launched) in paths.items():
        entry = {}
        for run in ("cold", "warm"):
            _reset_counts()
            stdout, stats, wall = invoke([*command, *common, "--device", DEVICE])
            launches, _generic = _read_counts()
            scans = json.loads(stdout)["scans"]
            check(len(scans) == CLI_OBJECTS, f"cli {path} {run}: {len(scans)} scans, expected {CLI_OBJECTS}")
            check('"?"' not in stdout, f"cli {path} {run}: an unknown ('?') value in the scan")
            check(all(launches[name] >= 1 for name in launched),
                  f"cli {path} {run}: a kernel of the path did not launch: {launches}")
            check(all(launches[name] == 0 for name in launches if name not in launched),
                  f"cli {path} {run}: a kernel of another path launched: {launches}")
            check(stats["failed_rows"] == 0, f"cli {path} {run}: failed rows {stats['failed_rows']}")
            entry[run] = {"wall_seconds": wall, "runner_stats": stats, "launches": launches}
            rendered[path] = stdout
        report["paths"][path] = entry
    check(rendered["tdigest_exact"] == rendered["simple"], "cli: tdigest exact_upgrade JSON != simple JSON")
    check(native.library_loaded(), "cli: the native scanner did not load")
    check(report["paths"]["simple"]["warm"]["runner_stats"]["streamed_queries"] > 0,
          "cli: no stats query took the native streamed route")
    report["native_library"] = native.SO_PATH

    report["subprocess"] = _cli_instrumented_subprocess(common, rendered["simple"], os.path.dirname(kubeconfig))

    stdout, stats, wall = invoke(["simple", *common, "--device", "cpu"])
    report["cpu_run"] = {"wall_seconds": wall, "runner_stats": stats}
    check(stdout == rendered["simple"], "cli: the --device cpu run's JSON != the card's simple JSON")

    stdout, stats, wall = invoke(["tdigest", *common, "--device", "cpu"])
    report["cpu_run_tdigest"] = {"wall_seconds": wall, "runner_stats": stats,
                                 "identical_cpu_values": same_within_a_bucket(rendered["tdigest"], stdout)}
    report.update(_cli_ingest(invoke, common))
    report.update(_cli_state(invoke, common, rendered["tdigest"], os.path.dirname(kubeconfig)))
    emit("cli", **report)
    return report


def _cli_instrumented_subprocess(common: list, simple_json: str, tmp: str) -> dict:
    """``python3 -m krr_tpu_torch simple`` in a child process with every
    observability flag: ``--trace``, ``--profile``, ``--statusz``,
    ``--metrics-dump`` and ``--log-format json`` (logs on stderr, so not
    ``-q``). Its stdout equals the in-process JSON; the stage spans are
    children of ``compute``, and the ``h2d`` stages' bytes are what
    ``krr_tpu_h2d_bytes_total`` counted; the profile's categories partition its wall;
    statusz counts every fetched row; the dump holds the card's peak
    allocated memory and a compile-cache hit without a miss (the kernels
    were built before); every stderr line is a JSON record, and each but
    the greeting (logged before the scan span opens, as in the JAX
    package) carries the trace's scan id."""
    paths = {kind: os.path.join(tmp, name) for kind, name in (
        ("trace", "trace.json"), ("profile", "profile.json"), ("statusz", "statusz.json"),
        ("metrics", "metrics.prom"),
    )}
    args = [arg for arg in common if arg != "-q"]
    started = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "krr_tpu_torch", "simple", *args, "--device", DEVICE, "--logtostderr",
         "--log-format", "json", "--trace", paths["trace"], "--profile", paths["profile"],
         "--statusz", paths["statusz"], "--metrics-dump", paths["metrics"]],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, timeout=600,
    )
    wall = time.perf_counter() - started
    check(proc.returncode == 0, f"python3 -m krr_tpu_torch simple exited {proc.returncode}: {proc.stderr[-2000:]}")
    check(proc.stdout == simple_json, "cli: the subprocess's JSON != the in-process simple JSON")

    with open(paths["trace"]) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    (root,) = [e for e in spans if e["name"] == "scan"]
    (compute,) = [e for e in spans if e["name"] == "compute"]
    stages = [e["name"] for e in sorted(spans, key=lambda e: e["ts"])
              if e["args"]["parent_id"] == compute["args"]["span_id"]]
    check(stages == ["pack", "cast", "h2d", "cast", "h2d", "quantile", "round"],
          f"cli: the stages under compute are {stages}")
    copied = {e["args"]["resource"]: e["args"]["bytes"] for e in spans if e["name"] == "h2d"}
    scan_id = root["args"]["trace_id"]

    with open(paths["profile"]) as f:
        (profile,) = json.load(f)["scans"]
    partition = sum(profile["categories"].values())
    check(abs(partition - profile["wall_seconds"]) <= 1e-3,
          f"cli: the profile's categories sum to {partition} s, its wall is {profile['wall_seconds']} s")

    with open(paths["statusz"]) as f:
        statusz = json.load(f)
    objectives = {o["name"]: o for o in statusz["objectives"]}
    check(objectives["fetch_failed_rows"]["events"] == {"bad": 0.0, "total": float(CLI_OBJECTS)},
          f"cli: statusz fetch events {objectives['fetch_failed_rows']['events']}")
    check(statusz["firing"] == [], f"cli: statusz alerts firing {statusz['firing']}")

    with open(paths["metrics"]) as f:
        samples = {}
        for line in f:
            if not line.startswith("#"):
                key, value = line.rsplit(" ", 1)
                samples[key] = float(value)
    peak = samples.get('krr_tpu_device_memory_bytes{device="cuda:0",kind="peak_bytes_in_use"}', 0.0)
    check(peak > 0, "cli: no peak device memory in the metrics dump")
    counted = {r: samples.get(f'krr_tpu_h2d_bytes_total{{resource="{r}"}}') for r in copied}
    check(counted == copied and set(copied) == {"cpu", "memory"},
          f"cli: krr_tpu_h2d_bytes_total {counted} != the h2d spans' bytes {copied}")
    hits = samples.get("krr_tpu_compile_cache_hits_total", 0.0)
    misses = samples.get("krr_tpu_compile_cache_misses_total", 0.0)
    check(hits >= 1 and misses == 0, f"cli: compile cache hits {hits}, misses {misses} (the kernels were built)")

    lines = proc.stderr.splitlines()
    records = []
    for line in lines:
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            raise SmokeFailure(f"cli: a stderr line is not JSON: {line[:300]!r}") from None
    greeting = [r["message"] for r in records if "scan_id" not in r]
    scanned = [r for r in records if "scan_id" in r]
    check(len(greeting) == 3 and greeting[0].startswith("Running krr-tpu-torch"),
          f"cli: log lines without a scan id beyond the greeting: {greeting}")
    check(scanned and all(r["scan_id"] == scan_id for r in scanned),
          f"cli: log lines whose scan id is not the trace's {scan_id}")
    return {
        "wall_seconds": wall, "stages": stages, "profile_wall_seconds": profile["wall_seconds"],
        "profile_categories": profile["categories"], "statusz_objectives": {
            name: {"events": o["events"], "firing": o["firing"]} for name, o in objectives.items()},
        "peak_device_bytes": peak, "compile_cache_hits": hits, "compile_cache_misses": misses,
        "log_lines": len(records), "log_lines_with_scan_id": len(scanned),
    }


def _cli_ingest(invoke, common: list) -> dict:
    """``tdigest --digest_ingest true`` streamed (``--pipeline-depth 4``) and
    staged (``0``), in ABBA order so the two compare within one run: the
    same stdout, no kernel launched (the query is host numpy, as in the JAX
    package), the pipeline's legs printed."""
    runs, outputs = {}, {}
    for run, depth in (("4a", "4"), ("0a", "0"), ("0b", "0"), ("4b", "4")):
        _reset_counts()
        stdout, stats, wall = invoke(["tdigest", "--digest_ingest", "true", "--pipeline-depth", depth, *common,
                                      "--device", DEVICE])
        launches, _generic = _read_counts()
        check(not any(launches.values()), f"cli digest_ingest depth {depth}: a kernel launched: {launches}")
        check(len(json.loads(stdout)["scans"]) == CLI_OBJECTS and '"?"' not in stdout,
              f"cli digest_ingest depth {depth}: missing or unknown scans")
        check(stats["failed_rows"] == 0, f"cli digest_ingest depth {depth}: failed rows {stats['failed_rows']}")
        check(("pipeline_batches" in stats) == (depth != "0"), f"cli digest_ingest depth {depth}: pipeline stats")
        outputs[run] = stdout
        runs[run] = {"wall_seconds": wall, "runner_stats": stats, "launches": launches}
    check(len(set(outputs.values())) == 1, "cli digest_ingest: --pipeline-depth 4 and 0 print different JSON")
    return {"digest_ingest": runs}


def _cli_state(invoke, common: list, tdigest_json: str, tmp: str) -> dict:
    """``tdigest --state_path`` on the card: twice into one sharded state
    (the second run doubles every count and appends one WAL record), once
    into a legacy file (the first run's arrays), and once with ``--device
    cpu`` (the first run's arrays but for one-bucket moves of edge
    samples). Each on-card run launches ``digest_hist`` and ``row_max``
    once and renders ``tdigest``'s memory, each CPU value within a bucket
    (but the second run's, which ranks twice the samples)."""
    import numpy as np

    runs, arrays = {}, {}
    for name, state, extra in (
        ("sharded_1", "sharded", []), ("sharded_2", "sharded", []),
        ("legacy", "legacy.npz", ["--store_format", "legacy"]), ("cpu", "cpu", []),
    ):
        path = os.path.join(tmp, state)
        device = "cpu" if name == "cpu" else DEVICE
        _reset_counts()
        stdout, stats, wall = invoke(["tdigest", "--state_path", path, *extra, *common, "--device", device])
        launches, _generic = _read_counts()
        if device != "cpu":
            check(launches == {**{k: 0 for k in launches}, "digest_hist": 1, "row_max": 1},
                  f"cli state {name}: launches {launches}, expected digest_hist 1 and row_max 1")
        check(stats["failed_rows"] == 0, f"cli state {name}: failed rows {stats['failed_rows']}")
        arrays[name] = store_arrays(path)
        # The second run answers from twice the samples: its CPU ranks (and
        # so its buckets) may differ from one window's; memory may not.
        runs[name] = {"wall_seconds": wall, "runner_stats": stats, "launches": launches,
                      "identical_cpu_values": same_within_a_bucket(tdigest_json, stdout, name != "sharded_2")}
        if state != "legacy.npz":
            runs[name]["live_wal_records"] = wal_records(path)
    appends = [tuple(runs[name]["runner_stats"]["store_stats"][k] for k in ("wal_appends", "epoch"))
               for name in ("sharded_1", "sharded_2", "legacy")]
    check(appends == [(1, 1), (1, 2), (0, 0)],
          f"cli state: (WAL appends, epoch) per run {appends}: each sharded run must append one record")
    first, second = arrays["sharded_1"], arrays["sharded_2"]
    doubled = {**first, "cpu_counts": 2 * first["cpu_counts"], "cpu_total": 2 * first["cpu_total"],
               "mem_total": 2 * first["mem_total"]}
    check(same_store_bits(np, second, doubled), "cli state: the second run did not double the first run's counts")
    check(same_store_bits(np, arrays["legacy"], first), "cli state: the legacy file != the sharded state's arrays")
    cpu = arrays["cpu"]
    check(same_store_bits(np, {**cpu, "cpu_counts": first["cpu_counts"]}, first),
          "cli state: --device cpu totals or peaks != the card's")
    moved, wider = bucket_moves(np, cpu["cpu_counts"], first["cpu_counts"])
    check(wider == 0, f"cli state: {wider} samples moved more than one bucket between the card and the CPU")
    return {"state": runs, "state_cpu_samples_moved_one_bucket": moved}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--phases",
        default="build,parity,digest_proof,headline,bench,e2e,stream,state,mesh,distributed,cli,serve,push,"
        "federation,eval",
        help="comma-separated subset of build,parity,digest_proof,headline,bench,e2e,stream,state,mesh,distributed,"
        "cli,serve,push,federation,eval,row_max_main (default: the first fifteen; the kernels line and the ok line "
        "need all fifteen)",
    )
    args = parser.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this needs one CUDA GPU", file=sys.stderr)
        return 2
    import numpy as np

    import krr_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    smi = nvidia_smi()
    emit("device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    walls = {}

    def timed(name, fn, *args):
        started = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - started
        return out

    if "build" in phases:
        timed("build", phase_build)
    if "row_max_main" in phases:
        timed("row_max_main", phase_row_max_main, torch, np)
    parity = timed("parity", phase_parity, torch, np) if "parity" in phases else None
    proof = timed("digest_proof", phase_digest_proof) if "digest_proof" in phases else None
    headline = timed("headline", phase_headline, torch, np) if "headline" in phases else None
    if headline is not None:
        headline.update(timed("headline_sketch", phase_sketch_headline, torch, np))
        headline.update(timed("headline_stream", phase_stream_headline, torch, np))
    benched = timed("bench", phase_bench) if "bench" in phases else None
    fleet = timed("fleet", E2EFleet, np) if {"e2e", "stream", "state"} & phases else None
    e2e, rendered = timed("e2e", phase_e2e, torch, fleet) if "e2e" in phases else (None, None)
    stream = timed("stream", phase_stream, torch, fleet, rendered) if "stream" in phases else None
    state = timed("state", phase_state, torch, np, fleet, rendered) if "state" in phases else None
    del fleet, rendered  # the fleet's 9.7 GB of samples are not needed past here
    cut, references = None, None
    if {"mesh", "distributed"} & phases:
        cut = timed("cut_fleet", E2EFleet, np, 0, MESH_SAMPLES_PER_POD)
        references = timed("cut_references", resident_scans, cut)
    mesh = timed("mesh", phase_mesh, torch, np, cut, references) if "mesh" in phases else None
    del cut  # each rank of ``distributed`` makes its own
    distributed = timed("distributed", phase_distributed, torch, np, references) if "distributed" in phases else None
    # Started here, after the timed phases: the fixture builds (tens of
    # seconds of one host core each, in two child processes started
    # together) must not overlap the kernel timings. One fixture serves the
    # ``cli``, ``serve`` and ``push`` phases; ``federation`` has its own.
    fakes = FakeServers(CLI_OBJECTS, CLI_SAMPLES) if {"cli", "serve", "push"} & phases else None
    fed_fakes = FakeServers(FED_OBJECTS, CLI_SAMPLES, FED_NAMESPACES) if "federation" in phases else None
    import tempfile

    with tempfile.TemporaryDirectory(prefix="krr-smoke-") as keep_dir:
        try:
            cli = timed("cli", phase_cli, fakes) if "cli" in phases else None
            serve = timed("serve", phase_serve, fakes, smi, keep_dir) if "serve" in phases else None
            pushed = timed("push", phase_push, fakes, smi) if "push" in phases else None
            if fakes is not None:
                fakes.close()
            federation = timed("federation", phase_federation, fed_fakes, smi) if "federation" in phases else None
        finally:
            for fixture in (fakes, fed_fakes):
                if fixture is not None:
                    fixture.close()
        journal = serve["journal_copy"] if serve is not None else None
        evaluated = timed("eval", phase_eval, torch, np, smi, journal) if "eval" in phases else None
    emit("walls", seconds=walls)
    if None in (headline, benched, e2e, stream, state, mesh, distributed, cli, serve, pushed, federation, evaluated,
                parity, proof) \
            or "build" not in phases:
        print(smi)
        return 0
    launched = {"cli": lambda path: cli["paths"][path]["warm"]["launches"],
                "stream": lambda path: stream["scans"][path]["launches"]}
    kernels = []
    for name, (replaces, source, phase, path) in KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launched[phase](path)[name],
            "max_abs_err": max(parity[name], headline[name]["max_abs_err"]),
            "ms": headline[name]["ms"], "plain_ms": headline[name]["plain_ms"],
            "bound_ms": headline[name]["bound_ms"], "bound_by": headline[name]["bound_by"],
            "library_ms": headline[name]["library_ms"],
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
