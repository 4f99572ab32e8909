#!/usr/bin/env python3
"""End-to-end scale benchmark of the port: the real Runner against fakes.

The counterpart of `bench_e2e.py` on `krr_tpu_torch`. `bench_torch.py`
isolates the kernels; this script drives the whole pipeline — discover
(apiserver list + pod resolution) → Prometheus fan-out → native parse →
pack → device compute → severity — through the port's `Runner` against the
hermetic fake apiserver and Prometheus of `tests/fakes/servers.py`, plus the
digest-ingest compute path on a synthetic 100k-container fleet, the
durable digest store and the native scanner's ingest rates.

Every leg's `Config` carries ``--device`` (default ``cuda``): the raw
``simple`` scan launches ``bisect_select`` and ``row_max`` on the card.
Digest ingest, the store and the scanner legs are host code and launch no
kernel, as in the JAX package.

The fakes run in a separate process (``spawn``), so the server's GIL never
blocks the scanner's; batched response bodies are rendered on the first
(cold) scan and served from the fake's cache on the warm scans that give
the numbers. Digest-ingest scans run the streamed scan pipeline
(`krr_tpu_torch.core.pipeline`); the fleet leg also times a
``pipeline_depth=0`` staged control at the same warm caches and records the
measured stage overlap (``fleet_e2e_overlap_pct``).

Prints ONE JSON line with `bench_e2e.py`'s field names:
    {"e2e_objects_per_sec": N, "e2e_objects_per_sec_cold": N,
     "e2e_containers": N, "discover_seconds": N, "fetch_seconds": N,
     "compute_seconds": N, "e2e_digest_objects_per_sec": N, ...,
     "digest_ingest_100k_objects_per_sec": N,
     "fleet_e2e_*": ...,     # one full-fleet scan, staged control, overlap
     "digest_store_*": ...,  # store merge/query/save/load + MB
     "ingest_*": ...}        # scanner sink throughputs + bytes/sample

Env knobs (`bench_e2e.py`'s names and defaults): BENCH_E2E_CONTAINERS
(1000; `bench_torch.py` sets 10000), BENCH_E2E_SAMPLES (1344 = 2 weeks at
15 min, the reference's workload shape), BENCH_E2E_INGEST_ROWS (100000; 0
skips), BENCH_E2E_FLEET_ROWS (100000; 0 skips the full-fleet scan),
BENCH_E2E_FLEET_ONLY (run only the full-fleet scan), BENCH_E2E_STORE_ROWS
(100000; 0 skips the store leg). Unlike `bench_e2e.py`, a failed leg is
not turned into a note: the script fails.

    python3 bench_e2e_torch.py [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import io
import json
import os
import sys
import tempfile
import time


def _serve_fixture(n_containers: int, samples: int, conn, shared: int = 0) -> None:
    """Child-process entry: build the fixture, serve it, report the port,
    hold until the parent is done or gone. Runs under multiprocessing
    ``spawn``, so this module must stay importable without side effects.

    ``shared > 0``: only the first ``shared`` pods get independently
    generated (and rendered) series; the rest serve one of those by
    reference (`FakeMetrics.alias_series`) — identical histories across
    pods do not change what the scanner has to do."""
    import numpy as np

    from tests.fakes.servers import FakeBackend, FakeCluster, FakeMetrics, ServerThread

    cluster = FakeCluster()
    metrics = FakeMetrics()
    # Range-accurate serving: each split window gets exactly its slice. The
    # scan pins its end (scan_end, below) onto this grid.
    metrics.enforce_range = True
    rng = np.random.default_rng(5)
    pods = []
    for i in range(n_containers):
        (pod,) = cluster.add_workload_with_pods("Deployment", f"wl-{i}", "default", pod_count=1)
        pods.append(pod)
        if shared and i >= shared:
            metrics.alias_series("default", "main", pod, pods[i % shared])
        else:
            # Realistic precision (irates ~0.1 millicore, page-granular
            # working sets): iid full-precision mantissas would make the
            # bodies incompressible and benchmark the RNG on the wire.
            metrics.set_series(
                "default",
                "main",
                pod,
                cpu=np.round(rng.gamma(2.0, 0.05, samples), 4),
                memory=np.floor(rng.uniform(5e7, 4e8, samples) / 4096) * 4096,
            )
    server = ServerThread(FakeBackend(cluster, metrics)).start()
    try:
        conn.send(server.port)
        with contextlib.suppress(EOFError, OSError):  # a parent that died closes the pipe
            conn.recv()
    finally:
        server.stop()


def _proc_cpu_seconds(pid: int) -> float:
    """utime+stime of one process from /proc/<pid>/stat — the fake server's
    CPU share of a scan, read from the parent."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            fields = f.read().rsplit(b")", 1)[1].split()
        return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return float("nan")


@contextlib.contextmanager
def _fixture_env(n_containers: int, samples: int, device: str, shared: int = 0):
    """Spawn the fake backend in a child process and yield
    ``(make_config, one_scan)``. ``make_config(**overrides)`` builds a
    `Config` on ``device`` against the fakes; ``one_scan(config)`` runs one
    full Runner scan and returns ``(elapsed_seconds, runner.stats)``, the
    stats carrying the fake server's CPU seconds for that scan
    (``server_cpu_seconds``), the transport phases, wire bytes, kernel
    launches and fetch-plan counts."""
    import multiprocessing

    import yaml

    from krr_tpu_torch.core.config import Config
    from krr_tpu_torch.core.runner import Runner
    from krr_tpu_torch.integrations.prometheus import TRANSPORT_PHASES
    from krr_tpu_torch.ops import cuda_select, cuda_sketch
    from krr_tpu_torch.strategies.simple import SimpleStrategySettings
    from tests.fakes.servers import FakeBackend

    ctx = multiprocessing.get_context("spawn")
    parent_conn, child_conn = ctx.Pipe()
    proc = ctx.Process(target=_serve_fixture, args=(n_containers, samples, child_conn, shared), daemon=True)
    proc.start()
    try:
        if not parent_conn.poll(timeout=600):
            raise RuntimeError("fake-server subprocess failed to start within 600 s")
        try:
            port = parent_conn.recv()
        except EOFError:  # the child died building the fixture
            raise RuntimeError("fake-server subprocess died during fixture setup") from None
        server_url = f"http://127.0.0.1:{port}"
        with tempfile.TemporaryDirectory() as tmp:
            kubeconfig = os.path.join(tmp, "config")
            with open(kubeconfig, "w") as f:
                yaml.safe_dump(
                    {
                        "current-context": "fake",
                        "contexts": [{"name": "fake", "context": {"cluster": "fake", "user": "u"}}],
                        "clusters": [{"name": "fake", "cluster": {"server": server_url}}],
                        "users": [{"name": "u", "user": {"token": "t"}}],
                    },
                    f,
                )
            # Pin the window's right edge so the fake's range-anchored series
            # line up with the scan exactly (the strategy's 15-minute step).
            step_seconds = SimpleStrategySettings().timeframe_timedelta.total_seconds()
            scan_end = FakeBackend.SERIES_ORIGIN + (samples - 1) * step_seconds

            def make_config(**overrides) -> Config:
                return Config(
                    kubeconfig=kubeconfig,
                    prometheus_url=server_url,
                    quiet=True,
                    format="json",
                    scan_end_timestamp=scan_end,
                    device=device,
                    **overrides,
                )

            def one_scan(config) -> tuple[float, dict]:
                runner = Runner(config)
                cuda_select.reset_launches()
                cuda_sketch.reset_launches()
                server_cpu = _proc_cpu_seconds(proc.pid)
                start = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):  # the result JSON is not the metric
                    asyncio.run(runner.run())
                elapsed = time.perf_counter() - start
                if runner.stats["objects"] != n_containers:
                    raise RuntimeError(f"scanned {runner.stats['objects']} objects, expected {n_containers}")
                stats = runner.stats
                stats["server_cpu_seconds"] = _proc_cpu_seconds(proc.pid) - server_cpu
                stats["kernel_launches"] = {**cuda_select.LAUNCHES, **cuda_sketch.LAUNCHES}
                # Transport phases of this scan's fetch leg, summed over every
                # range query (phases that never occurred read 0).
                for phase in TRANSPORT_PHASES:
                    stats[f"prom_phase_{phase}_seconds"] = (
                        runner.metrics.value("krr_tpu_prom_phase_seconds_sum", phase=phase) or 0.0
                    )
                # Wire = what crossed the socket (compressed when negotiated);
                # decoded = the post-inflate stream the scanner parsed.
                stats["prom_wire_bytes"] = runner.metrics.total("krr_tpu_prom_wire_bytes_total")
                stats["prom_decoded_bytes"] = runner.metrics.total("krr_tpu_prom_decoded_bytes_total")
                stats["prom_gzip_responses"] = (
                    runner.metrics.value("krr_tpu_prom_wire_encoding_total", encoding="gzip") or 0.0
                )
                for kind in ("coalesced", "sharded"):
                    stats[f"fetch_plan_{kind}"] = runner.metrics.total(f"krr_tpu_fetch_plan_{kind}_total")
                return elapsed, stats

            yield make_config, one_scan
    finally:
        with contextlib.suppress(OSError):  # the child already gone must not mask the real failure
            parent_conn.send("done")
        proc.join(timeout=10)
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=10)


def run_e2e(n_containers: int, samples: int, device: str = "cuda") -> dict:
    with _fixture_env(n_containers, samples, device) as (make_config, one_scan):
        config = make_config()
        # The cold scan pays the kernels' library load and the fake's body
        # renders; the warm scan is what a recommender running on a
        # schedule sees.
        cold_elapsed, _cold = one_scan(config)
        elapsed, stats = one_scan(config)
        if device != "cpu" and not (
            stats["kernel_launches"]["bisect_select"] and stats["kernel_launches"]["row_max"]
        ):
            raise RuntimeError(f"the simple scan on {device} launched no kernel: {stats['kernel_launches']}")

        # tdigest with digest-at-ingest: responses fold into per-object
        # digests inside the native scanner; raw arrays never materialise.
        # Same server, warm body cache.
        digest_config = config.model_copy(update={"strategy": "tdigest", "other_args": {"digest_ingest": True}})
        one_scan(digest_config)  # cold
        digest_elapsed, digest_stats = one_scan(digest_config)

        # The proxied route at the same scale: the raw transport declines
        # (as it does under HTTP(S)_PROXY) and streamed ingest rides httpx
        # into the same native sinks.
        from krr_tpu_torch.integrations.prometheus import PrometheusLoader

        original_transport = PrometheusLoader.__dict__["_make_raw_transport"]
        PrometheusLoader._make_raw_transport = staticmethod(lambda url, headers, verify: None)
        try:
            one_scan(digest_config)  # warm the httpx route
            proxied_elapsed, proxied_stats = one_scan(digest_config)
        finally:
            # The descriptor itself (class __dict__), not the bare function:
            # re-assigning the unwrapped function would bind `self` as `url`
            # on instance access and break every later fetch.
            PrometheusLoader._make_raw_transport = original_transport

    return {
        "e2e_objects_per_sec": round(stats["objects"] / elapsed, 1),
        "e2e_objects_per_sec_cold": round(stats["objects"] / cold_elapsed, 1),
        "e2e_containers": int(stats["objects"]),
        "discover_seconds": round(stats["discover_seconds"], 3),
        "fetch_seconds": round(stats["fetch_seconds"], 3),
        "compute_seconds": round(stats["compute_seconds"], 3),
        "e2e_kernel_launches": stats["kernel_launches"],
        "e2e_digest_objects_per_sec": round(digest_stats["objects"] / digest_elapsed, 1),
        "e2e_digest_fetch_seconds": round(digest_stats["fetch_seconds"], 3),
        "e2e_digest_overlap_pct": round(digest_stats.get("pipeline_overlap_pct", 0.0), 1),
        "e2e_digest_proxied_objects_per_sec": round(proxied_stats["objects"] / proxied_elapsed, 1),
        "e2e_digest_proxied_fetch_seconds": round(proxied_stats["fetch_seconds"], 3),
    }


def run_fleet_e2e(n_containers: int = 100_000, samples: int = 1344, shared: int = 512, device: str = "cuda") -> dict:
    """One full scan at the config-4 width, measured: ``n_containers``
    containers through discover → namespace-batched fetch → streamed native
    digest ingest → percentile → severity against the fake backend, the
    window pinned by ``scan_end_timestamp``. Digest-ingest route only: raw
    fetch at this width is bounded by the metrics backend, which a local
    fake cannot represent. ``shared`` caps how many distinct series the
    fake renders; pods beyond it serve shared histories by reference."""
    with _fixture_env(n_containers, samples, device, shared=shared) as (make_config, one_scan):
        config = make_config(
            strategy="tdigest",
            other_args={"digest_ingest": True},
            # Compressed transport (the default) + server-side downsampling
            # on the stats route; the pinned scan_end sits on the step grid.
            fetch_downsample="auto",
        )
        cold_elapsed, cold_stats = one_scan(config)
        # Warm: the fake's window bodies cached. Best of 2.
        elapsed, stats = min((one_scan(config) for _ in range(2)), key=lambda pair: pair[0])
        # Staged control at the same warm caches: pipeline_depth=0 gathers,
        # then folds — the streamed/staged ratio as one measured pair.
        staged_elapsed, _staged_stats = min(
            (one_scan(config.model_copy(update={"pipeline_depth": 0})) for _ in range(2)),
            key=lambda pair: pair[0],
        )
    return {
        "fleet_e2e_containers": int(stats["objects"]),
        "fleet_e2e_objects_per_sec": round(stats["objects"] / elapsed, 1),
        "fleet_e2e_objects_per_sec_cold": round(cold_stats["objects"] / cold_elapsed, 1),
        "fleet_e2e_seconds": round(elapsed, 3),
        "fleet_e2e_cold_seconds": round(cold_elapsed, 3),
        "fleet_e2e_staged_seconds": round(staged_elapsed, 3),
        "fleet_e2e_vs_staged": round(elapsed / staged_elapsed, 3) if staged_elapsed else None,
        "fleet_e2e_overlap_pct": round(stats.get("pipeline_overlap_pct", 0.0), 1),
        "fleet_e2e_pipeline_fetch_seconds": round(stats.get("pipeline_fetch_seconds", 0.0), 3),
        "fleet_e2e_pipeline_fold_seconds": round(stats.get("pipeline_fold_seconds", 0.0), 3),
        # Producer put-blocked = fold-bound, consumer get-starved = fetch-bound.
        "fleet_e2e_put_blocked_seconds": round(stats.get("pipeline_put_blocked_seconds", 0.0), 3),
        "fleet_e2e_get_starved_seconds": round(stats.get("pipeline_get_starved_seconds", 0.0), 3),
        # Transport phases of the warm fetch leg, summed per query (concurrent
        # queries overlap, so these can pass the fetch wall).
        **{
            f"fleet_e2e_phase_{key.split('prom_phase_')[1]}": round(value, 3)
            for key, value in stats.items()
            if key.startswith("prom_phase_")
        },
        "fleet_e2e_wire_mb": round(stats.get("prom_wire_bytes", 0.0) / 1e6, 1),
        "fleet_e2e_decoded_mb": round(stats.get("prom_decoded_bytes", 0.0) / 1e6, 1),
        "fleet_e2e_wire_ratio": (
            round(stats.get("prom_decoded_bytes", 0.0) / stats["prom_wire_bytes"], 2)
            if stats.get("prom_wire_bytes") and stats.get("prom_gzip_responses")
            else None
        ),
        "fleet_e2e_discover_seconds": round(stats["discover_seconds"], 3),
        "fleet_e2e_fetch_seconds": round(stats["fetch_seconds"], 3),
        "fleet_e2e_compute_seconds": round(stats["compute_seconds"], 3),
        # fetch / (discover + compute): "fetch within ~2x" reads <= ~2.
        "fleet_e2e_fetch_ratio": round(
            stats["fetch_seconds"] / max(stats["discover_seconds"] + stats["compute_seconds"], 1e-9), 3
        ),
        "fleet_e2e_plan_coalesced": stats.get("fetch_plan_coalesced", 0.0),
        "fleet_e2e_plan_sharded": stats.get("fetch_plan_sharded", 0.0),
        # The warm wall's owners: client CPU per phase against the fake's CPU.
        "fleet_e2e_discover_cpu_seconds": round(stats["discover_cpu_seconds"], 3),
        "fleet_e2e_fetch_cpu_seconds": round(stats["fetch_cpu_seconds"], 3),
        "fleet_e2e_compute_cpu_seconds": round(stats["compute_cpu_seconds"], 3),
        # null, not NaN, when /proc is not readable — NaN is not valid JSON.
        "fleet_e2e_server_cpu_seconds": (
            round(stats["server_cpu_seconds"], 3)
            if stats["server_cpu_seconds"] == stats["server_cpu_seconds"]
            else None
        ),
    }


def run_ingest_throughput(n_series: int = 1000, samples: int = 2688) -> dict:
    """The native scanner's ingest legs on a pre-rendered namespace-batched
    body, no network: fused parse+digest (``ingest_digest_bytes_per_sec``),
    parse+count/max (``ingest_stats_bytes_per_sec``), raw float64 collection
    (``ingest_raw_bytes_per_sec``), and the density
    (``ingest_samples_per_sec``, ``ingest_bytes_per_sample``)."""
    import numpy as np

    from krr_tpu_torch.integrations import native

    rng = np.random.default_rng(17)
    fragments = []
    for i in range(n_series):
        values = ",".join(
            f'[{1700000000 + 5 * t},"{float(v)!r}"]' for t, v in enumerate(rng.gamma(2.0, 0.05, samples))
        )
        fragments.append('{"metric":{"pod":"wl-%d-0","container":"main"},"values":[%s]}' % (i, values))
    body = ('{"status":"success","data":{"resultType":"matrix","result":[%s]}}' % ",".join(fragments)).encode()
    total_samples = n_series * samples

    def best_of(fn, runs=3) -> float:
        fn()  # warm (and build the library on first use)
        return min(_timed(fn) for _ in range(runs))

    def _timed(fn) -> float:
        start = time.perf_counter()
        fn()
        return time.perf_counter() - start

    digest_s = best_of(lambda: native.parse_matrix_digest(body, 1.01, 1e-7, 2560))
    stats_s = best_of(lambda: native.parse_matrix_stats(body))
    raw_s = best_of(lambda: native.parse_matrix(body))
    return {
        "ingest_bytes_per_sample": round(len(body) / total_samples, 2),
        "ingest_samples_per_sec": round(total_samples / digest_s, 1),
        "ingest_digest_bytes_per_sec": round(len(body) / digest_s, 1),
        "ingest_stats_bytes_per_sec": round(len(body) / stats_s, 1),
        "ingest_raw_bytes_per_sec": round(len(body) / raw_s, 1),
    }


def run_digest_store_scale(n_rows: int = 100_000) -> dict:
    """DigestStore at config-4/5 width: fold an ``n_rows`` window into the
    store, query p99, save and load. Counts are band-sparse like real
    fleets (40 active buckets a row of 2,560)."""
    import numpy as np

    from krr_tpu_torch.core.streaming import DigestStore
    from krr_tpu_torch.ops.digest import DigestSpec

    spec = DigestSpec(gamma=1.01, min_value=1e-7, num_buckets=2560)
    rng = np.random.default_rng(23)
    keys = [f"c/ns-{i % 64}/wl-{i}/main/Deployment" for i in range(n_rows)]
    counts = np.zeros((n_rows, spec.num_buckets), dtype=np.float32)
    bands = rng.integers(200, 2300, size=n_rows)
    for offset in range(40):  # 40 active buckets a row (bands stay < 2560)
        counts[np.arange(n_rows), bands + offset] += rng.integers(1, 60, size=n_rows)
    totals = counts.sum(axis=1)
    peaks = rng.gamma(2.0, 0.3, n_rows).astype(np.float32)

    store = DigestStore(spec=spec)
    start = time.perf_counter()
    store.merge_window(keys, counts, totals, peaks, totals, peaks * 1e3)
    merge_s = time.perf_counter() - start

    start = time.perf_counter()
    p99 = store.cpu_percentile(np.arange(n_rows), 99.0)
    query_s = time.perf_counter() - start
    if not np.isfinite(p99).all():
        raise RuntimeError("the store's p99 holds a non-finite value")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        start = time.perf_counter()
        store.save(path)
        save_s = time.perf_counter() - start
        size_mb = os.path.getsize(path) / 1e6
        start = time.perf_counter()
        loaded = DigestStore.load(path)
        load_s = time.perf_counter() - start
        if len(loaded.keys) != n_rows:
            raise RuntimeError(f"the reloaded store holds {len(loaded.keys)} rows, expected {n_rows}")

    return {
        "digest_store_rows": n_rows,
        "digest_store_merge_seconds": round(merge_s, 3),
        "digest_store_query_p99_seconds": round(query_s, 3),
        "digest_store_save_seconds": round(save_s, 3),
        "digest_store_load_seconds": round(load_s, 3),
        "digest_store_file_mb": round(size_mb, 1),
    }


def run_digest_ingest(n_rows: int, device: str = "cuda") -> dict:
    """Time the digest-ingest compute path (``run_digested``: host
    percentile query + Decimal finalize + severity-ready results) on a
    synthetic pre-digested fleet of ``n_rows`` rows."""
    import numpy as np

    from krr_tpu_torch.models.allocations import ResourceAllocations, ResourceType
    from krr_tpu_torch.models.objects import K8sObjectData
    from krr_tpu_torch.models.series import DigestedFleet
    from krr_tpu_torch.strategies.tdigest import TDigestStrategy, TDigestStrategySettings

    settings = TDigestStrategySettings(digest_ingest=True, device=device)
    spec = settings.cpu_spec()
    allocations = ResourceAllocations(
        requests={ResourceType.CPU: "100m", ResourceType.Memory: "128Mi"},
        limits={ResourceType.CPU: None, ResourceType.Memory: None},
    )
    objects = [
        K8sObjectData(
            cluster="c", namespace="default", name=f"wl-{i}", kind="Deployment",
            container="main", pods=[f"wl-{i}-0"], allocations=allocations,
        )
        for i in range(n_rows)
    ]
    fleet = DigestedFleet.empty(objects, spec.gamma, spec.min_value, spec.num_buckets)
    rng = np.random.default_rng(9)
    # ~2,000 samples a row over a band of buckets: the shapes, not the
    # values, set the time.
    band = rng.integers(400, 2000, size=n_rows)
    fleet.cpu_counts[np.arange(n_rows), band] = 1500.0
    fleet.cpu_counts[np.arange(n_rows), band + 10] = 500.0
    fleet.cpu_total[:] = 2000.0
    fleet.cpu_peak[:] = 1.0
    fleet.mem_total[:] = 2000.0
    fleet.mem_peak[:] = rng.uniform(5e7, 4e8, n_rows)

    strategy = TDigestStrategy(settings)
    start = time.perf_counter()
    results = strategy.run_digested(fleet)
    elapsed = time.perf_counter() - start
    if len(results) != n_rows:
        raise RuntimeError(f"run_digested returned {len(results)} results for {n_rows} rows")
    return {"digest_ingest_100k_objects_per_sec": round(n_rows / elapsed, 1)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain PyTorch versions)")
    args = parser.parse_args(argv)

    from krr_tpu_torch.utils.device import resolve_device

    try:
        device = str(resolve_device(args.device))
    except (RuntimeError, ValueError) as e:
        print(f"bench_e2e: no CUDA card for --device {args.device}: {e}", file=sys.stderr)
        return 1

    n = int(os.environ.get("BENCH_E2E_CONTAINERS", 1000))
    samples = int(os.environ.get("BENCH_E2E_SAMPLES", 1344))
    ingest_rows = int(os.environ.get("BENCH_E2E_INGEST_ROWS", 100_000))
    fleet_rows = int(os.environ.get("BENCH_E2E_FLEET_ROWS", 100_000))

    def fleet_leg() -> dict:
        if not fleet_rows:
            return {}
        out = run_fleet_e2e(fleet_rows, samples, device=device)
        print(
            f"bench_e2e: FULL fleet scan at {out['fleet_e2e_containers']} containers -> "
            f"{out['fleet_e2e_objects_per_sec']:.0f} objects/s warm "
            f"({out['fleet_e2e_seconds']}s: discover {out['fleet_e2e_discover_seconds']}s, "
            f"fetch {out['fleet_e2e_fetch_seconds']}s (ratio {out['fleet_e2e_fetch_ratio']}), "
            f"compute {out['fleet_e2e_compute_seconds']}s; "
            f"staged control {out['fleet_e2e_staged_seconds']}s -> x{out['fleet_e2e_vs_staged']}, "
            f"pipeline overlap {out['fleet_e2e_overlap_pct']}%, "
            f"waits put {out['fleet_e2e_put_blocked_seconds']}s / get {out['fleet_e2e_get_starved_seconds']}s, "
            f"{out['fleet_e2e_wire_mb']} MB wire (decoded {out['fleet_e2e_decoded_mb']} MB); "
            f"cold {out['fleet_e2e_cold_seconds']}s; warm CPU: client fetch "
            f"{out['fleet_e2e_fetch_cpu_seconds']}s, server {out['fleet_e2e_server_cpu_seconds']}s)",
            file=sys.stderr,
        )
        return out

    if int(os.environ.get("BENCH_E2E_FLEET_ONLY", 0)):
        print(json.dumps(fleet_leg()))
        return 0

    out = run_e2e(n, samples, device)
    print(
        f"bench_e2e: {out['e2e_containers']} containers x {samples} samples -> "
        f"{out['e2e_objects_per_sec']:.0f} objects/s end-to-end "
        f"(discover {out['discover_seconds']}s, fetch {out['fetch_seconds']}s, "
        f"compute {out['compute_seconds']}s; launches {out['e2e_kernel_launches']}); digest-ingest "
        f"{out['e2e_digest_objects_per_sec']:.0f} objects/s (fetch {out['e2e_digest_fetch_seconds']}s)",
        file=sys.stderr,
    )
    if ingest_rows:
        out.update(run_digest_ingest(ingest_rows, device))
        print(
            f"bench_e2e: digest_ingest at {ingest_rows} rows -> "
            f"{out['digest_ingest_100k_objects_per_sec']:.0f} objects/s",
            file=sys.stderr,
        )
    store_rows = int(os.environ.get("BENCH_E2E_STORE_ROWS", 100_000))
    if store_rows:
        out.update(run_digest_store_scale(store_rows))
        print(
            f"bench_e2e: DigestStore at {store_rows} rows x 2560 buckets -> "
            f"merge {out['digest_store_merge_seconds']}s, p99 query {out['digest_store_query_p99_seconds']}s, "
            f"save {out['digest_store_save_seconds']}s ({out['digest_store_file_mb']} MB), "
            f"load {out['digest_store_load_seconds']}s",
            file=sys.stderr,
        )
    out.update(run_ingest_throughput())
    print(
        f"bench_e2e: scanner ingest {out['ingest_digest_bytes_per_sec']/1e6:.0f} MB/s digest-sink, "
        f"{out['ingest_stats_bytes_per_sec']/1e6:.0f} MB/s stats-sink, "
        f"{out['ingest_raw_bytes_per_sec']/1e6:.0f} MB/s raw ({out['ingest_bytes_per_sample']} B/sample)",
        file=sys.stderr,
    )
    # Blended transfer+ingest rates of the two streamed digest routes, from
    # the measured bytes/sample density (estimates): total samples =
    # containers x samples x 2 resources.
    total_bytes = n * samples * 2 * out["ingest_bytes_per_sample"]
    for route, fetch_key in (("raw", "e2e_digest_fetch_seconds"), ("proxied", "e2e_digest_proxied_fetch_seconds")):
        if out.get(fetch_key):
            out[f"e2e_digest_{route}_blended_mb_per_sec_est"] = round(total_bytes / out[fetch_key] / 1e6, 1)
    # A standalone run includes the fleet leg; bench_torch.py runs it in a
    # subprocess of its own (FLEET_ROWS=0 here, FLEET_ONLY there).
    out.update(fleet_leg())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
