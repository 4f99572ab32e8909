"""Device-level compute observability: staged spans, compile accounting,
padding efficiency, and memory watermarks.

Port of `krr_tpu/obs/device.py`. A scan trace shows ``compute`` as one
span; this module splits it with five instruments, all wired through
:class:`DeviceObs` (one per scan session, injected into the strategy as
``strategy.obs``):

* **Stage spans** — :meth:`DeviceObs.stage` opens a child span of the
  active ``compute`` span for each compute leg (``pack`` → ``cast`` →
  ``h2d`` → ``digest``/``fold`` → ``quantile`` → ``persist`` → ``round``;
  ``cast`` and ``h2d`` once per resource). Spans measure WALL time, and CUDA
  launches are asynchronous — a stage that merely enqueues kernels would
  read as free while the next stage pays for them — so call sites fence
  device results through :meth:`DeviceObs.fence` before the span closes.
  The fence records an event on the current stream of each CUDA device the
  result lives on (the stream the kernel wrappers launch on) and waits for
  it; unlike the JAX fence it swallows nothing: an asynchronous kernel
  fault that surfaces there is raised. Fencing serializes host and device,
  so it (like every instrument here that could perturb the hot path) only
  runs when the tracer is recording: with :data:`NULL_TRACER` a stage is the
  shared no-op context and ``fence`` is the identity. A recording stage
  also carries ``minor_faults``, the process's minor page faults across it
  (``getrusage``): what faulting in fresh buffers costs the pack.

* **Compile vs execute split** — the port has no JIT; its compile is the
  nvcc build of `krr_tpu_torch.ops.cuda_build`. :func:`install_compile_hooks`
  registers one process-wide listener in ``cuda_build.BUILD_HOOKS`` that
  (a) feeds the shared registry (``krr_tpu_compile_seconds{phase=
  "backend_compile"}`` with each build's nvcc wall,
  ``krr_tpu_compile_cache_{hits,misses}_total``: a hit when ``load`` finds
  the hashed library already built, a miss per source nvcc compiled) and
  (b) advances a process-global compile clock. A recording stage reads the
  clock at enter/exit: a nonzero delta means this stage's wall includes a
  build, and the span gains ``compile_seconds`` / ``execute_seconds``
  attributes splitting the two. The JAX ``trace``/``lower`` phases have no
  counterpart and never fire.

* **Padding efficiency** — :meth:`DeviceObs.record_padding` turns a packed
  batch into ``krr_tpu_pad_waste_pct{resource=…}`` and
  ``krr_tpu_packed_elements{resource=…,kind=real|padding}`` gauges (a
  partition: the two kinds sum to the rectangular matrix), and sets
  ``krr_tpu_pack_workers{resource=…}``, the threads that filled the batch.
  Cheap (one counts-sum per batch), so it fires on every mode, tracer or not.

* **H2D bytes** — :meth:`DeviceObs.record_h2d` adds the bytes each
  resource's resident arrays copied to the device to
  ``krr_tpu_h2d_bytes_total{resource=…}``, on every scan (the ``h2d``
  stage carries the same count as ``bytes`` when recording).

* **Memory watermarks** — :meth:`DeviceObs.record_device_memory` reads
  ``torch.cuda.memory_stats`` (allocated now and at peak) and
  ``torch.cuda.mem_get_info`` (the card's total) of each visible card into
  ``krr_tpu_device_memory_bytes{device="cuda:<i>"}``; a strategy computing
  on the CPU records nothing. Neither read synchronizes the device, and a
  CUDA failure raises.
"""

from __future__ import annotations

import dataclasses
import resource
import threading
import time
from typing import Any, Optional

from krr_tpu_torch.obs.metrics import MetricsRegistry
from krr_tpu_torch.obs.trace import NULL_TRACER, NullTracer
from krr_tpu_torch.ops.packing import padding_stats

#: ``cuda_build`` events → our counters.
_EVENT_COUNTERS = {
    "hit": "krr_tpu_compile_cache_hits_total",
    "miss": "krr_tpu_compile_cache_misses_total",
}

_hook_lock = threading.Lock()
_hooks_installed = False
#: The registry build events currently land in. ONE listener forwards to a
#: swappable target — last installer wins (each scan session installs its
#: own registry; in-process tests get deterministic counts the same way).
_target: Optional[MetricsRegistry] = None
#: Monotone total of build seconds this process has spent — the clock
#: stage spans diff to attribute compile time.
_compile_seconds = 0.0


def compile_seconds_total() -> float:
    """Process-wide build seconds so far (see the module docstring)."""
    return _compile_seconds


def _on_build(event: str, seconds: float) -> None:
    global _compile_seconds
    target = _target
    if event == "compile":
        _compile_seconds += seconds
        if target is not None:
            target.observe("krr_tpu_compile_seconds", seconds, phase="backend_compile")
        return
    name = _EVENT_COUNTERS.get(event)
    if name is not None and target is not None:
        target.inc(name)


def install_compile_hooks(metrics: MetricsRegistry) -> None:
    """Route the kernel builds' events into ``metrics`` (and the process
    compile clock). Idempotent: the listener is registered once, the target
    registry is swapped on every call."""
    global _hooks_installed, _target
    _target = metrics
    with _hook_lock:
        if _hooks_installed:
            return
        from krr_tpu_torch.ops import cuda_build

        cuda_build.BUILD_HOOKS.append(_on_build)
        _hooks_installed = True


def _minor_faults() -> int:
    """The process's minor page faults so far: every thread's, so the
    threads a pack or a cast may use count too (a scan runs one stage at a
    time)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_minflt


class _Stage:
    """A recording compute stage: the underlying tracer span plus the
    compile-clock bracket that splits its wall into compile vs execute, and
    the page-fault bracket that stamps ``minor_faults``."""

    __slots__ = ("_ctx", "_t0", "_compile0", "_faults0")

    def __init__(self, ctx) -> None:
        self._ctx = ctx

    def __enter__(self):
        self._compile0 = compile_seconds_total()
        self._faults0 = _minor_faults()
        self._t0 = time.perf_counter()
        return self._ctx.__enter__()

    def __exit__(self, exc_type, exc, tb) -> bool:
        wall = time.perf_counter() - self._t0
        compiled = compile_seconds_total() - self._compile0
        self._ctx.span.set(minor_faults=_minor_faults() - self._faults0)
        if compiled > 0.0:
            self._ctx.span.set(
                compile_seconds=round(compiled, 6),
                execute_seconds=round(max(0.0, wall - compiled), 6),
            )
        return self._ctx.__exit__(exc_type, exc, tb)


def _cuda_devices(value: Any, found: set) -> None:
    """Collect the CUDA devices of every tensor inside ``value`` (tensors,
    tuples and named tuples, lists, dicts, dataclasses)."""
    import torch

    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            found.add(value.device)
    elif isinstance(value, (tuple, list)):
        for item in value:
            _cuda_devices(item, found)
    elif isinstance(value, dict):
        for item in value.values():
            _cuda_devices(item, found)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for field in dataclasses.fields(value):
            _cuda_devices(getattr(value, field.name), found)


class DeviceObs:
    """Per-session device-compute instrumentation (see module docstring).

    Always constructed with a REAL metrics registry (metrics are labeled
    dicts — cheap) but usually the no-op tracer: stage spans and fencing
    only activate when the tracer records, so the hot path stays untouched
    on the default CLI scan."""

    __slots__ = ("tracer", "metrics")

    def __init__(
        self, tracer: NullTracer = NULL_TRACER, metrics: Optional[MetricsRegistry] = None
    ) -> None:
        self.tracer = tracer
        self.metrics = metrics

    @property
    def enabled(self) -> bool:
        return self.tracer.enabled

    def stage(self, name: str, **attributes: Any):
        """A compute-stage span (child of the active ``compute`` span via
        contextvar propagation — including across ``asyncio.to_thread``).
        No-op (the shared null context, no allocation) when not recording."""
        if not self.tracer.enabled:
            return self.tracer.span(name, **attributes)
        return _Stage(self.tracer.span(name, **attributes))

    def fence(self, value):
        """When recording, wait for the current stream of each CUDA device
        ``value``'s tensors live on (an event recorded there, then
        synchronized), so a stage's wall covers its kernels; the identity
        otherwise, and for host values. Returns ``value``."""
        if not self.tracer.enabled:
            return value
        devices: set = set()
        _cuda_devices(value, devices)
        if devices:
            import torch

            for device in devices:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(device))
                event.synchronize()
        return value

    def record_padding(self, resource: str, packed) -> None:
        """Padding-efficiency gauges from one packed batch
        (`krr_tpu_torch.ops.packing.padding_stats`), and the threads that
        filled it (``krr_tpu_pack_workers``)."""
        if self.metrics is None:
            return
        self.metrics.set("krr_tpu_pack_workers", packed.workers, resource=resource)
        real, total = padding_stats(packed.counts, packed.capacity)
        # A true partition: real + padding = the rectangular matrix the
        # device reads, so the two kinds sum meaningfully on a dashboard.
        self.metrics.set("krr_tpu_packed_elements", real, resource=resource, kind="real")
        self.metrics.set(
            "krr_tpu_packed_elements", total - real, resource=resource, kind="padding"
        )
        waste = 100.0 * (total - real) / total if total else 0.0
        self.metrics.set("krr_tpu_pad_waste_pct", waste, resource=resource)

    def record_h2d(self, resource: str, nbytes: int) -> None:
        """``krr_tpu_h2d_bytes_total{resource}`` += the bytes one resource's
        resident arrays copied host to device (every scan, tracer or not)."""
        if self.metrics is not None:
            self.metrics.inc("krr_tpu_h2d_bytes_total", nbytes, resource=resource)

    def record_device_memory(self, device) -> None:
        """Device memory watermarks of every visible card, when the strategy
        computes on ``device`` of type ``cuda``; nothing on the CPU."""
        if self.metrics is None or device.type != "cuda":
            return
        import torch

        for index in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(index)
            _free, total = torch.cuda.mem_get_info(index)
            label = f"cuda:{index}"
            for kind, value in (
                ("bytes_in_use", stats.get("allocated_bytes.all.current", 0)),
                ("peak_bytes_in_use", stats.get("allocated_bytes.all.peak", 0)),
                ("bytes_limit", total),
            ):
                self.metrics.set("krr_tpu_device_memory_bytes", value, device=label, kind=kind)


#: The inert default every strategy carries until a scan session wires in
#: its own (`krr_tpu_torch.core.runner.ScanSession`): null tracer, no
#: registry.
NULL_DEVICE_OBS = DeviceObs()
