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

What the one-shot raw scan reads: ``parse_matrix`` (response bytes → list of
((pod, container), float64 samples); the key is the series' ``pod`` /
``container`` label pair, either component ``""`` when the query's grouping
omits that label), ``parse_matrix_stats`` (per-series count + exact max) and
the streamed stats sink (:class:`StreamIngest`). The fused digest parse and
the remote-write decoder of `krr_tpu/integrations/native.py` wait for the
digest-ingest and push-ingest slices.
"""

from __future__ import annotations

import ctypes
import json
import os
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


class StreamIngest:
    """Streaming stats parse over arbitrary chunk boundaries
    (`native/faststream.cpp`): feed response bytes as they arrive from the
    socket; per-series (count, max) accumulate in native memory, so neither
    the body nor raw samples are ever materialized. None from
    :func:`open_stream` when the native library is unavailable — callers
    fall back to buffered parsing.

    Usage::

        stream = open_stream()
        while chunk := read(...):
            stream.feed(chunk)
        series = stream.finish()   # SeriesStats
    """

    def __init__(self, lib, handle: int):
        self._lib = lib
        self._handle = handle
        #: Serializes every native call against abort(): on the httpx route
        #: feed/finish run in executor threads, and a cancelled awaiter's
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
        ``bytearray``) without materializing a ``bytes`` copy per chunk. The
        native parser consumes the bytes before returning (anything
        unconsumed is copied into its own carry), so the caller may refill
        ``buf`` as soon as this returns."""
        with self._op_lock:
            if self._handle is None:
                raise ValueError("stream already finished")
            ptr = ctypes.cast((ctypes.c_char * n).from_buffer(buf), ctypes.c_char_p)
            if self._lib.krr_stream_feed(self._handle, ptr, n) != 0:
                raise ValueError("malformed Prometheus stream")

    def finish(self) -> "SeriesStats":
        """Close the stream and return ``[(key, total, peak), …]``."""
        with self._op_lock:
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
                    return []
                names_cap = self._lib.krr_stream_names_len(handle)
                names = ctypes.create_string_buffer(names_cap)
                totals = np.zeros(n, dtype=np.float64)
                peaks = np.zeros(n, dtype=np.float64)
                rc = self._lib.krr_stream_read(
                    handle,
                    names,
                    names_cap,
                    totals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    peaks.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    None,
                    n,
                )
                if rc != 0:
                    raise ValueError("stream readout capacity mismatch")
                keys = _split_keys(names.raw[:names_cap], n)
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

    def __del__(self):
        # Safety net for ownership gaps (e.g. a consumer cancelled between
        # fetch and finish). No lock: reachable refcount zero means no
        # concurrent op can hold the stream.
        handle = getattr(self, "_handle", None)
        if handle is not None:
            self._handle = None
            self._lib.krr_stream_free(handle)


def stream_available() -> bool:
    """Whether streaming ingest exists here (native library loaded)."""
    return _load_library() is not None


def open_stream(reserve_series: int = 0) -> Optional[StreamIngest]:
    """A streaming stats-ingest handle, or None when the native library (the
    only implementation) is unavailable. ``reserve_series`` pre-sizes the
    native state for the expected series count (the probed estimate, padded
    for churn): no realloc-doubling copies (a reserve failure silently falls
    back to growth-on-demand)."""
    lib = _load_library()
    if lib is None:
        return None
    # num_buckets=0 selects the native stats-only sink.
    handle = lib.krr_stream_new(0.0, 0.0, 0)
    if not handle:
        return None
    if reserve_series > 0:
        lib.krr_stream_reserve(handle, reserve_series + reserve_series // 8 + 64)
    return StreamIngest(lib, handle)


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
