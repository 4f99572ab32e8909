"""ctypes bridge to the native Prometheus-matrix scanner (`native/`).

The C++ sources at the repo root (`native/fastsamples.cpp`,
`native/faststream.cpp`) are shared with the JAX package; this package builds
its OWN copy of the library from them, with the same flags, into the
git-ignored `krr_tpu_torch/csrc/build/` — never into `native/`, where the JAX
package rebuilds its library in place (two packages writing one ``.so`` would
race). The build runs with g++ on first use (a temporary file renamed into
place, so concurrent processes never load a half-written library) and falls
back to the pure-Python parser when no compiler is available: the native path
is a host optimization, not a requirement. ``KRR_TPU_NATIVE_DIR`` points an
installed copy at the sources.

What the scans read: ``parse_matrix`` (response bytes → list of
((pod, container), float64 samples); the key is the series' ``pod`` /
``container`` label pair, either component ``""`` when the query's grouping
omits that label), ``parse_matrix_stats`` (per-series count + exact max),
the fused parse+digest ``parse_matrix_digest`` (digest ingest), and the
streamed sink (:class:`StreamIngest`, stats or digest mode). Digest ingest
bucketizes with the same C++ code as the JAX package, so both packages'
ingest digests agree bit for bit. Push ingest reads the remote-write decoder
(:func:`decode_remote_write`: snappy block + protobuf ``WriteRequest`` →
label records, samples, timestamps, per-series counts; native scanner with a
pure-Python twin) and :func:`digest_samples`, the same bucketizer the range
fetch uses.
"""

from __future__ import annotations

import ctypes
import json
import os
import struct
import subprocess
import threading
from typing import Optional

import numpy as np

#: Where the C++ sources live: the repo checkout layout by default,
#: overridable for installed deployments whose site-packages copy has no
#: sibling ``native/`` directory.
_NATIVE_DIR = os.environ.get(
    "KRR_TPU_NATIVE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native"),
)
_SOURCES = ("fastsamples.cpp", "faststream.cpp")
#: The port's own build of the library (git-ignored; see the module doc).
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "build")
SO_PATH = os.path.join(BUILD_DIR, "libfastsamples.so")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_build_failed = False


def _build() -> None:
    """Compile the library when missing OR stale (older than any ``.cpp`` /
    ``.h`` under the source directory — a cached library from older sources
    would load but lack newer symbols)."""
    sources = [os.path.join(_NATIVE_DIR, name) for name in _SOURCES]
    for source in sources:
        if not os.path.exists(source):
            raise FileNotFoundError(source)
    inputs = [
        os.path.join(_NATIVE_DIR, f) for f in os.listdir(_NATIVE_DIR) if f.endswith((".cpp", ".h"))
    ]
    if os.path.exists(SO_PATH) and max(map(os.path.getmtime, inputs)) <= os.path.getmtime(SO_PATH):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{SO_PATH}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, *sources],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, SO_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load_library() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            _build()
            lib = ctypes.CDLL(SO_PATH)
            lib.krr_parse_matrix.restype = ctypes.c_long
            lib.krr_parse_matrix.argtypes = [
                ctypes.c_char_p,
                ctypes.c_long,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_long,
                ctypes.POINTER(ctypes.c_long),
                ctypes.c_long,
                ctypes.c_char_p,
                ctypes.c_long,
            ]
            lib.krr_parse_matrix_digest.restype = ctypes.c_long
            lib.krr_parse_matrix_digest.argtypes = [
                ctypes.c_char_p,
                ctypes.c_long,
                ctypes.c_double,
                ctypes.c_double,
                ctypes.c_long,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_long,
                ctypes.c_char_p,
                ctypes.c_long,
            ]
            lib.krr_parse_matrix_stats.restype = ctypes.c_long
            lib.krr_parse_matrix_stats.argtypes = [
                ctypes.c_char_p,
                ctypes.c_long,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_long,
                ctypes.c_char_p,
                ctypes.c_long,
            ]
            lib.krr_count_series.restype = ctypes.c_long
            lib.krr_count_series.argtypes = [ctypes.c_char_p, ctypes.c_long]
            lib.krr_stream_new.restype = ctypes.c_void_p
            lib.krr_stream_new.argtypes = [ctypes.c_double, ctypes.c_double, ctypes.c_long]
            lib.krr_stream_feed.restype = ctypes.c_long
            lib.krr_stream_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
            lib.krr_stream_finish.restype = ctypes.c_long
            lib.krr_stream_finish.argtypes = [ctypes.c_void_p]
            lib.krr_stream_names_len.restype = ctypes.c_long
            lib.krr_stream_names_len.argtypes = [ctypes.c_void_p]
            lib.krr_stream_read.restype = ctypes.c_long
            lib.krr_stream_read.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p,
                ctypes.c_long,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_long,
            ]
            lib.krr_stream_free.restype = None
            lib.krr_stream_free.argtypes = [ctypes.c_void_p]
            lib.krr_stream_reserve.restype = ctypes.c_long
            lib.krr_stream_reserve.argtypes = [ctypes.c_void_p, ctypes.c_long]
            lib.krr_stream_fold_into.restype = ctypes.c_long
            lib.krr_stream_fold_into.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_long),
                ctypes.c_long,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_long,
            ]
            lib.krr_rw_uncompressed_len.restype = ctypes.c_longlong
            lib.krr_rw_uncompressed_len.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
            lib.krr_rw_decode.restype = ctypes.c_longlong
            lib.krr_rw_decode.argtypes = [
                ctypes.c_char_p,
                ctypes.c_longlong,
                ctypes.c_longlong,
                ctypes.c_char_p,
                ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.POINTER(ctypes.c_longlong),
            ]
            lib.krr_digest_array.restype = ctypes.c_longlong
            lib.krr_digest_array.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_longlong,
                ctypes.c_double,
                ctypes.c_double,
                ctypes.c_longlong,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
            ]
            _lib = lib
        except (OSError, AttributeError, subprocess.SubprocessError) as e:
            _build_failed = True
            # One-time notice: the pure-Python fallback is correct but ~20x
            # slower, and silence here would hide deployment mistakes
            # (missing source dir, no compiler).
            import logging

            logging.getLogger("krr_tpu_torch").info(
                "native parser unavailable (%s: %s) — using the pure-Python parser; "
                "set KRR_TPU_NATIVE_DIR to the directory holding fastsamples.cpp to enable it",
                type(e).__name__,
                e,
            )
    return _lib


def library_loaded() -> bool:
    """Whether the native scanner is in use (built and loaded) — False
    means every parse takes the pure-Python fallback."""
    return _load_library() is not None


#: Series identity: the (pod, container) label pair — or, on multi-namespace
#: coalesced queries whose grouping includes the namespace label,
#: (pod, container, namespace). Either of the first two components is ""
#: when the query's grouping omits that label; the namespace component is
#: present exactly when the response carried a non-empty namespace label, so
#: single-namespace queries keep their historical 2-tuple keys.
SeriesKey = tuple[str, ...]


def parse_matrix_python(body: bytes) -> list[tuple[SeriesKey, np.ndarray]]:
    """Reference implementation: json.loads + per-sample float().

    Raises on a non-success or shape-less payload (e.g. a proxy answering 200
    with ``{"status":"error"}``) so misconfigurations surface as logged query
    failures instead of silent empty histories."""
    payload = json.loads(body)
    if payload.get("status") != "success" or "result" not in payload.get("data", {}):
        raise ValueError(
            f"unexpected Prometheus response: status={payload.get('status')!r}, "
            f"error={payload.get('error')!r}"
        )
    result = payload["data"]["result"]
    series = []
    for entry in result:
        metric = entry.get("metric", {})
        key = (metric.get("pod", ""), metric.get("container", ""))
        if metric.get("namespace"):
            key = (*key, metric["namespace"])
        values = entry.get("values") or []
        samples = np.asarray([float(v) for _, v in values], dtype=np.float64)
        # Stale markers ("NaN") / division artifacts ("+Inf") carry no usage
        # information and would poison max/percentile reductions — drop them
        # (same rule as the native parser).
        series.append((key, samples[np.isfinite(samples)]))
    return series


def _names_cap(body: bytes, series_count: int) -> int:
    """Name-buffer size: series × (2 × k8s name limit 253 + '\\t' + '\\n'),
    never more than the response itself. If an exotic label still overflows,
    the native parser returns -1 and the caller falls back to Python — never
    truncation."""
    return max(4096, min(len(body), series_count * 512))


def _split_keys(names_value: bytes, n: int) -> list[SeriesKey]:
    """Decode the native names buffer: '\\n'-joined "pod\\tcontainer" records,
    extended to "pod\\tcontainer\\tnamespace" for series carrying a namespace
    label (multi-namespace coalesced queries) — the key arity mirrors the
    record's."""
    if not n:
        return []
    return [
        tuple(record.split("\t"))
        for record in names_value.decode("utf-8", errors="replace").split("\n")[:n]
    ]


def parse_matrix_native(body: bytes) -> Optional[list[tuple[SeriesKey, np.ndarray]]]:
    """Native parse; None when the library is unavailable or reports malformed
    input (caller falls back to Python)."""
    lib = _load_library()
    if lib is None:
        return None

    # Size buffers by over-allocation rather than a krr_count_series pre-scan:
    # the count would cost a full extra pass over every response on the bulk-
    # fetch hot path, while these buffers are transient and ~body-sized. (The
    # digest path keeps the pre-scan — there counting avoids a buckets×series
    # allocation that dwarfs the body.) Caps too small ⇒ -1 ⇒ Python fallback.
    values_cap = max(len(body) // 8, 1024)  # every sample costs >8 response bytes
    series_cap = max(len(body) // 24, 64)  # a series entry costs >24 bytes
    names_cap = max(len(body), 4096)
    values = np.empty(values_cap, dtype=np.float64)
    lens = np.empty(series_cap, dtype=np.int64)
    names = ctypes.create_string_buffer(names_cap)

    n = lib.krr_parse_matrix(
        body,
        len(body),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        values_cap,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        series_cap,
        names,
        names_cap,
    )
    if n < 0:
        return None
    keys = _split_keys(names.value, n)
    series = []
    offset = 0
    for i in range(n):
        length = int(lens[i])
        series.append((keys[i], values[offset : offset + length].copy()))
        offset += length
    return series


def parse_matrix(body: bytes) -> list[tuple[SeriesKey, np.ndarray]]:
    """Parse a query_range matrix response: native when possible, Python otherwise."""
    # Error payloads route through the Python parser, which raises with the
    # server's error message (the native scanner only understands matrices).
    if b'"status":"error"' not in body[:4096]:
        native = parse_matrix_native(body)
        if native is not None:
            return native
    return parse_matrix_python(body)


#: Result of a fused parse+digest pass: per-series (series key, bucket counts,
#: total sample count, exact max).
DigestedSeries = list[tuple[SeriesKey, np.ndarray, float, float]]


def _digest_python(samples: np.ndarray, gamma: float, min_value: float, num_buckets: int):
    """Vectorized fallback with the bucketize semantics of `krr_tpu_torch.ops.digest`."""
    counts = np.zeros(num_buckets, dtype=np.float64)
    if samples.size == 0:
        return counts, 0.0, -np.inf
    safe = np.maximum(samples, min_value)
    raw = np.floor(np.log(safe / min_value) / np.log(gamma)).astype(np.int64)
    idx = np.where(samples <= min_value, 0, 1 + np.clip(raw, 0, num_buckets - 2))
    np.add.at(counts, idx, 1.0)
    return counts, float(samples.size), float(samples.max())


def parse_matrix_digest(
    body: bytes, gamma: float, min_value: float, num_buckets: int
) -> DigestedSeries:
    """Fused parse + per-series digest accumulation.

    The streaming-ingest hot path: every sample goes straight from the
    response bytes into its log bucket (native single pass, O(num_buckets)
    memory per series — raw sample arrays are never materialized). Bucket
    layout matches `krr_tpu_torch.ops.digest.bucketize`; note the native path
    computes ``log`` in float64 while the device path uses float32, so a
    sample sitting exactly on a bucket boundary may land one bucket apart —
    within the digest's stated relative error, but not bit-identical.
    """
    lib = _load_library()
    if lib is not None and b'"status":"error"' not in body[:4096]:
        # Exact series count up front: the counts matrix is
        # series x num_buckets doubles, so a body-length-proportional guess
        # would allocate ~320x the response size for nothing.
        series_cap = lib.krr_count_series(body, len(body))
        if series_cap >= 0:
            names_cap = _names_cap(body, series_cap)
            counts = np.zeros((series_cap, num_buckets), dtype=np.float64)
            totals = np.zeros(series_cap, dtype=np.float64)
            peaks = np.zeros(series_cap, dtype=np.float64)
            names = ctypes.create_string_buffer(names_cap)
            n = lib.krr_parse_matrix_digest(
                body,
                len(body),
                gamma,
                min_value,
                num_buckets,
                counts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                totals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                peaks.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                series_cap,
                names,
                names_cap,
            )
            if n >= 0:
                keys = _split_keys(names.value, n)
                return [(keys[i], counts[i].copy(), float(totals[i]), float(peaks[i])) for i in range(n)]
    return [
        (key, *_digest_python(samples, gamma, min_value, num_buckets))
        for key, samples in parse_matrix(body)
    ]


class StreamIngest:
    """Streaming fused parse+fold over arbitrary chunk boundaries
    (`native/faststream.cpp`): feed response bytes as they arrive from the
    socket; per-series digests/stats accumulate in native memory, so neither
    the body nor raw samples are ever materialized. ``num_buckets=0`` selects
    the stats-only sink (memory resource). None from :func:`open_stream` when
    the native library is unavailable — callers fall back to buffered parsing.

    Usage::

        stream = open_stream(gamma, min_value, num_buckets)
        while chunk := read(...):
            stream.feed(chunk)
        series = stream.finish()   # DigestedSeries or SeriesStats
    """

    def __init__(self, lib, handle: int, num_buckets: int):
        self._lib = lib
        self._handle = handle
        self._num_buckets = num_buckets
        self._count: Optional[int] = None
        #: Serializes every native call against abort(): on the httpx route
        #: feed/finalize run in executor threads, and a cancelled awaiter's
        #: cleanup could otherwise free the handle WHILE a worker is still
        #: parsing into it (use-after-free). With the lock, abort blocks
        #: until the in-flight call returns; the late worker then sees the
        #: cleared handle and raises instead of touching freed memory.
        self._op_lock = threading.Lock()

    def feed(self, chunk: bytes) -> None:
        with self._op_lock:
            if self._handle is None:
                raise ValueError("stream already finished")
            if self._lib.krr_stream_feed(self._handle, chunk, len(chunk)) != 0:
                raise ValueError("malformed Prometheus stream")

    def feed_view(self, buf, n: int) -> None:
        """Feed the first ``n`` bytes of a REUSABLE writable buffer (a pooled
        ``bytearray``) without materializing a ``bytes`` copy per chunk — the
        zero-hop sink path's fast lane. The native parser consumes the bytes
        before returning (anything unconsumed is copied into its own carry),
        so the caller may refill ``buf`` as soon as this returns."""
        with self._op_lock:
            if self._handle is None:
                raise ValueError("stream already finished")
            ptr = ctypes.cast((ctypes.c_char * n).from_buffer(buf), ctypes.c_char_p)
            if self._lib.krr_stream_feed(self._handle, ptr, n) != 0:
                raise ValueError("malformed Prometheus stream")

    def finish_parse(self) -> "StreamIngest":
        """End-of-body validation WITHOUT reading anything out: the handle
        stays alive for :meth:`read_meta` / :meth:`fold_counts_into`, and the
        caller owns releasing it (:meth:`free`). This is the fleet fast path —
        the folded state crosses into Python as one band-sparse native add
        into the final arrays instead of a dense matrix readout."""
        with self._op_lock:
            handle = self._handle
            if handle is None:
                raise ValueError("stream already finished")
            n = self._lib.krr_stream_finish(handle)
            if n < 0:
                self._handle = None
                self._lib.krr_stream_free(handle)
                raise ValueError(
                    "truncated Prometheus stream (body ended mid-series)"
                    if n == -3
                    else "malformed Prometheus stream (no result array)"
                )
            self._count = int(n)
            return self

    def read_meta(self) -> tuple[bytes, np.ndarray, np.ndarray]:
        """(names bytes, totals, peaks) — the cheap per-series readout (no
        counts matrix) that lets the caller build a row mapping before the
        native counts fold. Requires :meth:`finish_parse`. The names bytes
        are '\\n'-joined "pod\\tcontainer" records (:func:`_split_keys`);
        identical bytes across windows mean an identical series list, so
        callers can reuse a cached mapping without decoding."""
        with self._op_lock:
            if self._handle is None or self._count is None:
                raise ValueError("read_meta requires a live, parse-finished stream")
            n = self._count
            totals = np.empty(n, dtype=np.float64)
            peaks = np.empty(n, dtype=np.float64)
            if not n:
                return b"", totals, peaks
            names_cap = self._lib.krr_stream_names_len(self._handle)
            names = ctypes.create_string_buffer(names_cap)
            rc = self._lib.krr_stream_read(
                self._handle,
                names,
                names_cap,
                totals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                peaks.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                None,
                n,
            )
            if rc != 0:
                raise ValueError("stream readout capacity mismatch")
            return names.raw[:names_cap], totals, peaks

    def fold_counts_into(self, rows: np.ndarray, dst: np.ndarray) -> None:
        """Add every series' touched bucket span into ``dst[rows[i]]``
        (``rows[i] < 0`` skips) — one GIL-released native pass straight into
        the caller's [n_rows × num_buckets] float64 accumulator (digest mode
        only). Requires :meth:`finish_parse`."""
        with self._op_lock:
            # Real exceptions, not asserts: these guard a raw native write —
            # stripped under ``python -O`` they would become out-of-bounds
            # memory corruption instead of a caller error.
            if self._handle is None or self._count is None:
                raise ValueError("fold_counts_into requires a live, parse-finished stream")
            if not (
                dst.dtype == np.float64
                and dst.flags["C_CONTIGUOUS"]
                and dst.ndim == 2
                and dst.shape[1] == self._num_buckets
            ):
                raise ValueError(
                    f"dst must be C-contiguous float64 [rows × {self._num_buckets}]"
                )
            rows = np.ascontiguousarray(rows, dtype=np.int64)
            if rows.shape != (self._count,):
                raise ValueError(f"rows must cover all {self._count} series")
            rc = self._lib.krr_stream_fold_into(
                self._handle,
                rows.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                self._count,
                dst.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                dst.shape[0],
            )
            if rc != 0:
                raise ValueError("stream fold shape/mode mismatch")

    def finish(self):
        """Close the stream and return the folded series.

        Digest mode returns the MATRIX form ``(keys, counts [n × buckets]
        float64, totals [n], peaks [n])`` — the arrays are exclusively owned
        by the caller. The earlier per-row tuple readout (one ``.copy()`` +
        tuple per series) cost ~3.7 s per 100k-series window, several times
        the native parse itself; consumers fold the matrix with vectorized
        ops instead (`krr_tpu_torch.integrations.prometheus`). Stats mode returns
        ``[(key, total, peak), …]`` — scalars, nothing to vectorize."""
        with self._op_lock:
            return self._finish_locked()

    def _finish_locked(self):
        handle, self._handle = self._handle, None
        if handle is None:
            raise ValueError("stream already finished")
        try:
            n = self._lib.krr_stream_finish(handle)
            if n < 0:
                raise ValueError(
                    "truncated Prometheus stream (body ended mid-series)"
                    if n == -3
                    else "malformed Prometheus stream (no result array)"
                )
            if n == 0:
                if self._num_buckets:
                    empty = np.zeros((0, self._num_buckets), dtype=np.float64)
                    return [], empty, np.zeros(0, np.float64), np.zeros(0, np.float64)
                return []
            names_cap = self._lib.krr_stream_names_len(handle)
            names = ctypes.create_string_buffer(names_cap)
            totals = np.zeros(n, dtype=np.float64)
            peaks = np.zeros(n, dtype=np.float64)
            counts = (
                np.zeros((n, self._num_buckets), dtype=np.float64)
                if self._num_buckets
                else None
            )
            rc = self._lib.krr_stream_read(
                handle,
                names,
                names_cap,
                totals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                peaks.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                counts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)) if counts is not None else None,
                n,
            )
            if rc != 0:
                raise ValueError("stream readout capacity mismatch")
            keys = _split_keys(names.raw[:names_cap], n)
            if counts is not None:
                return keys, counts, totals, peaks
            return [(keys[i], float(totals[i]), float(peaks[i])) for i in range(n)]
        finally:
            self._lib.krr_stream_free(handle)

    def abort(self) -> None:
        """Release native memory without reading results (fetch failed).
        Blocks until any in-flight native call on another thread returns —
        never frees under a live parser (see ``_op_lock``)."""
        with self._op_lock:
            handle, self._handle = self._handle, None
            if handle is not None:
                self._lib.krr_stream_free(handle)

    #: Terminal call of the finish_parse path (same release as a failed
    #: fetch's abort — the name marks intent at call sites).
    free = abort

    def __del__(self):
        # Safety net for ownership gaps (e.g. a consumer cancelled between
        # fetch and fold): a still-live handle pins up to GB-scale native
        # state, far too big to leave to process exit. No lock: reachable
        # refcount zero means no concurrent op can hold the stream.
        handle = getattr(self, "_handle", None)
        if handle is not None:
            self._handle = None
            self._lib.krr_stream_free(handle)


def stream_available() -> bool:
    """Whether streaming ingest exists here (native library loaded)."""
    return _load_library() is not None


def open_stream(
    gamma: float = 0.0, min_value: float = 0.0, num_buckets: int = 0, reserve_series: int = 0
) -> Optional[StreamIngest]:
    """A streaming ingest handle, or None when the native library (the only
    implementation) is unavailable. ``num_buckets=0`` (the default) = the
    stats-only sink.
    ``reserve_series`` pre-sizes the native state for the expected series
    count (the probed estimate, padded for churn): no realloc-doubling
    copies, and the counts matrix's untouched pages stay lazily zero-mapped
    (a reserve failure silently falls back to growth-on-demand)."""
    lib = _load_library()
    if lib is None:
        return None
    handle = lib.krr_stream_new(gamma, min_value, num_buckets)
    if not handle:
        return None
    if reserve_series > 0:
        lib.krr_stream_reserve(handle, reserve_series + reserve_series // 8 + 64)
    return StreamIngest(lib, handle, num_buckets)


#: Result of a stats-only parse: per-series (series key, total sample count,
#: exact max).
SeriesStats = list[tuple[SeriesKey, float, float]]


def parse_matrix_stats(body: bytes) -> SeriesStats:
    """Per-series count + exact max in one native pass — the memory-resource
    ingest (max × buffer needs no histogram, and no per-sample log())."""
    lib = _load_library()
    if lib is not None and b'"status":"error"' not in body[:4096]:
        series_cap = lib.krr_count_series(body, len(body))
        if series_cap >= 0:
            names_cap = _names_cap(body, series_cap)
            totals = np.zeros(series_cap, dtype=np.float64)
            peaks = np.zeros(series_cap, dtype=np.float64)
            names = ctypes.create_string_buffer(names_cap)
            n = lib.krr_parse_matrix_stats(
                body,
                len(body),
                totals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                peaks.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                series_cap,
                names,
                names_cap,
            )
            if n >= 0:
                keys = _split_keys(names.value, n)
                return [(keys[i], float(totals[i]), float(peaks[i])) for i in range(n)]
    return [
        (key, float(samples.size), float(samples.max()) if samples.size else float("-inf"))
        for key, samples in parse_matrix(body)
    ]


# --------------------------------------------------------------- remote-write
class RemoteWriteError(ValueError):
    """Malformed remote-write body (snappy framing or protobuf bytes) — the
    listener answers 400 and counts it; nothing was partially ingested."""


class RemoteWriteTooLarge(RemoteWriteError):
    """The snappy preamble promises more than the decode cap — rejected
    before allocating (decompression-bomb guard); the listener answers 413."""


#: Decoded remote-write body: '\n'-joined per-series records of '\t'-joined
#: label name/value fields (wire order), flat series-major float64 samples,
#: parallel int64 millisecond timestamps, and per-series sample counts. The
#: native and Python decoders produce bit-identical tuples — the decoder
#: parity test's contract.
DecodedWrite = tuple[bytes, np.ndarray, np.ndarray, np.ndarray]


#: Varints wrap at 64 bits and field numbers at 32, as in the native
#: scanner's ``unsigned long long`` / ``unsigned int`` reads: the JAX
#: package's twin keeps the unbounded Python integer, so a 10-byte varint
#: with high bits set decodes there to a different field, or to a timestamp
#: numpy cannot hold (``OverflowError``), where the native scanner decodes it.
_U64 = (1 << 64) - 1
_U32 = (1 << 32) - 1


def _snappy_decompress_python(body: bytes, max_decoded: int) -> bytes:
    """Snappy BLOCK format (the remote-write framing), pure Python: uvarint
    uncompressed-length preamble, then literal and 1/2/4-byte-offset copy
    tags. Same malformed-input rules as the native twin."""
    pos = 0
    expect = 0
    shift = 0
    while True:
        if pos >= len(body) or shift >= 64:
            raise RemoteWriteError("truncated snappy length preamble")
        b = body[pos]
        pos += 1
        expect |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    expect &= _U64
    if expect > 1 << 62:  # the native preamble read's bound
        raise RemoteWriteError("truncated snappy length preamble")
    if expect > max_decoded:
        raise RemoteWriteTooLarge(
            f"snappy preamble promises {expect} bytes (cap {max_decoded})"
        )
    out = bytearray()
    n = len(body)
    while pos < n:
        tag = body[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                if pos + extra > n:
                    raise RemoteWriteError("truncated snappy literal length")
                length = int.from_bytes(body[pos : pos + extra], "little") + 1
                pos += extra
            if pos + length > n or len(out) + length > expect:
                raise RemoteWriteError("truncated snappy literal")
            out += body[pos : pos + length]
            pos += length
        else:  # copy
            if kind == 1:
                length = ((tag >> 2) & 7) + 4
                if pos >= n:
                    raise RemoteWriteError("truncated snappy copy")
                offset = ((tag >> 5) << 8) | body[pos]
                pos += 1
            elif kind == 2:
                length = (tag >> 2) + 1
                if pos + 2 > n:
                    raise RemoteWriteError("truncated snappy copy")
                offset = int.from_bytes(body[pos : pos + 2], "little")
                pos += 2
            else:
                length = (tag >> 2) + 1
                if pos + 4 > n:
                    raise RemoteWriteError("truncated snappy copy")
                offset = int.from_bytes(body[pos : pos + 4], "little")
                pos += 4
            if offset <= 0 or offset > len(out) or len(out) + length > expect:
                raise RemoteWriteError("invalid snappy copy")
            # Overlapping copies (offset < length) are the RLE idiom: the
            # defined semantics is a byte-at-a-time forward copy.
            for _ in range(length):
                out.append(out[-offset])
    if len(out) != expect:
        raise RemoteWriteError("snappy output length mismatch")
    return bytes(out)


def _pb_varint(data: bytes, pos: int) -> tuple[int, int]:
    value = 0
    shift = 0
    while shift < 64:
        if pos >= len(data):
            raise RemoteWriteError("truncated protobuf varint")
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value & _U64, pos
        shift += 7
    raise RemoteWriteError("overlong protobuf varint")


def _pb_skip(data: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = _pb_varint(data, pos)
        return pos
    if wire_type == 1:
        pos += 8
    elif wire_type == 2:
        length, pos = _pb_varint(data, pos)
        pos += length
    elif wire_type == 5:
        pos += 4
    else:
        raise RemoteWriteError(f"unsupported protobuf wire type {wire_type}")
    if pos > len(data):
        raise RemoteWriteError("truncated protobuf field")
    return pos


def decode_remote_write_python(
    body: bytes, max_decoded: int = 64 << 20
) -> DecodedWrite:
    """Pure-Python remote-write decoder: the fallback twin of
    :func:`decode_remote_write_native`, and the oracle its parity test
    compares against. Raises :class:`RemoteWriteError` on malformed bytes."""
    data = _snappy_decompress_python(body, max_decoded)
    records: list[bytes] = []
    values: list[float] = []
    timestamps: list[int] = []
    lens: list[int] = []
    unpack_double = struct.Struct("<d").unpack_from

    pos = 0
    while pos < len(data):
        key, pos = _pb_varint(data, pos)
        field, wire_type = (key >> 3) & _U32, key & 7
        if field == 1 and wire_type == 2:  # repeated TimeSeries
            ts_len, pos = _pb_varint(data, pos)
            ts_end = pos + ts_len
            if ts_end > len(data):
                raise RemoteWriteError("truncated TimeSeries")
            fields: list[bytes] = []
            count = 0
            while pos < ts_end:
                sub_key, pos = _pb_varint(data, pos)
                sub_field, sub_wt = (sub_key >> 3) & _U32, sub_key & 7
                if sub_field in (1, 2) and sub_wt == 2:
                    sub_len, pos = _pb_varint(data, pos)
                    sub_end = pos + sub_len
                    if sub_end > ts_end:
                        raise RemoteWriteError("truncated TimeSeries submessage")
                    if sub_field == 1:  # Label{name, value}
                        name = value = b""
                        while pos < sub_end:
                            l_key, pos = _pb_varint(data, pos)
                            l_field, l_wt = (l_key >> 3) & _U32, l_key & 7
                            if l_field in (1, 2) and l_wt == 2:
                                l_len, pos = _pb_varint(data, pos)
                                if pos + l_len > sub_end:
                                    raise RemoteWriteError("truncated Label string")
                                chunk = data[pos : pos + l_len]
                                pos += l_len
                                if l_field == 1:
                                    name = chunk
                                else:
                                    value = chunk
                            else:
                                pos = _pb_skip(data, pos, l_wt)
                        if pos != sub_end:
                            # A skip crossed the Label boundary: the native
                            # scanner bounds every read by the submessage and
                            # rejects this — the twin must too.
                            raise RemoteWriteError("misaligned Label submessage")
                        if b"\t" in name or b"\n" in name or b"\t" in value or b"\n" in value:
                            raise RemoteWriteError("separator byte inside a label")
                        fields.append(name + b"\t" + value)
                    else:  # Sample{value, timestamp}
                        v = 0.0
                        ts = 0
                        while pos < sub_end:
                            s_key, pos = _pb_varint(data, pos)
                            s_field, s_wt = (s_key >> 3) & _U32, s_key & 7
                            if s_field == 1 and s_wt == 1:
                                if pos + 8 > sub_end:
                                    raise RemoteWriteError("truncated Sample value")
                                (v,) = unpack_double(data, pos)
                                pos += 8
                            elif s_field == 2 and s_wt == 0:
                                raw, pos = _pb_varint(data, pos)
                                # int64 two's complement, like the native cast
                                ts = raw - (1 << 64) if raw >= (1 << 63) else raw
                            else:
                                pos = _pb_skip(data, pos, s_wt)
                        if pos != sub_end:
                            raise RemoteWriteError("misaligned Sample submessage")
                        values.append(v)
                        timestamps.append(ts)
                        count += 1
                else:
                    pos = _pb_skip(data, pos, sub_wt)
            if pos != ts_end:
                raise RemoteWriteError("misaligned TimeSeries submessage")
            records.append(b"\t".join(fields))
            lens.append(count)
        else:  # metadata etc.: skipped
            pos = _pb_skip(data, pos, wire_type)
    return (
        b"\n".join(records),
        np.asarray(values, dtype=np.float64),
        np.asarray(timestamps, dtype=np.int64),
        np.asarray(lens, dtype=np.int64),
    )


def decode_remote_write_native(
    body: bytes, max_decoded: int = 64 << 20
) -> Optional[DecodedWrite]:
    """Native remote-write decode, or None when the library is unavailable /
    a capacity estimate fell short (callers fall back to the Python twin).
    Malformed bytes raise :class:`RemoteWriteError`, same as the fallback."""
    lib = _load_library()
    if lib is None:
        return None
    decoded_len = lib.krr_rw_uncompressed_len(body, len(body))
    if decoded_len < 0:
        raise RemoteWriteError("truncated snappy length preamble")
    if decoded_len > max_decoded:
        raise RemoteWriteTooLarge(
            f"snappy preamble promises {decoded_len} bytes (cap {max_decoded})"
        )
    # Worst-case shapes from the uncompressed size: a Sample can be 2 wire
    # bytes (empty submessage -> value 0 @ ts 0), a TimeSeries 2 bytes, and
    # the names arena adds at most one separator per >=2-byte wire string.
    values_cap = decoded_len // 2 + 16
    series_cap = decoded_len // 2 + 16
    names_cap = 2 * decoded_len + 64
    values = np.empty(values_cap, dtype=np.float64)
    timestamps = np.empty(values_cap, dtype=np.int64)
    lens = np.empty(series_cap, dtype=np.int64)
    names = ctypes.create_string_buffer(names_cap)
    out_values_n = ctypes.c_longlong(0)
    out_names_len = ctypes.c_longlong(0)
    n = lib.krr_rw_decode(
        body,
        len(body),
        max_decoded,
        names,
        names_cap,
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        timestamps.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        values_cap,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        series_cap,
        ctypes.byref(out_values_n),
        ctypes.byref(out_names_len),
    )
    if n == -1:
        return None  # capacity shortfall: let the Python twin handle it
    if n == -3:
        raise RemoteWriteTooLarge("decoded size exceeds the cap")
    if n < 0:
        raise RemoteWriteError("malformed remote-write body")
    return (
        names.raw[: out_names_len.value],
        values[: out_values_n.value].copy(),
        timestamps[: out_values_n.value].copy(),
        lens[:n].copy(),
    )


def decode_remote_write(body: bytes, max_decoded: int = 64 << 20) -> DecodedWrite:
    """Decode one remote-write body: native scanner when available, pure
    Python otherwise — identical outputs either way."""
    decoded = decode_remote_write_native(body, max_decoded)
    if decoded is None:
        decoded = decode_remote_write_python(body, max_decoded)
    return decoded


def digest_samples(
    samples: np.ndarray, gamma: float, min_value: float, num_buckets: int
) -> tuple[np.ndarray, float, float]:
    """Digest a plain sample array through the SAME implementation the range
    fetch uses: the native bucketizer when the library is loaded, the Python
    fallback otherwise. The push ingest plane folds through this so push-fed
    windows are bit-identical to range-fetched ones in either regime (the
    two bucketize expressions can round a boundary-sitting sample into
    adjacent buckets; mixing them across paths would break the push-vs-pull
    exactness gate)."""
    lib = _load_library()
    samples = np.ascontiguousarray(samples, dtype=np.float64)
    if lib is None:
        return _digest_python(samples, gamma, min_value, num_buckets)
    counts = np.zeros(num_buckets, dtype=np.float64)
    if samples.size == 0:
        return counts, 0.0, -np.inf
    total = ctypes.c_double(0.0)
    peak = ctypes.c_double(0.0)
    rc = lib.krr_digest_array(
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        samples.size,
        gamma,
        min_value,
        num_buckets,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(total),
        ctypes.byref(peak),
    )
    if rc != 0:
        raise ValueError(f"invalid digest parameters (gamma={gamma}, min_value={min_value})")
    return counts, total.value, peak.value
