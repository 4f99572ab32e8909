"""Shared time-axis chunk scans for mergeable builds.

Port of `krr_tpu/ops/chunked.py`. Both sketch families (log-bucket digest,
exact top-K), the streamed row max and the streamed radix select fold a
packed ``[N, T]`` matrix chunk by chunk into a fixed-size state, and the
validity contract lives here, once: a position is valid iff it is inside the
matrix's real width AND its *global* position (local + ``time_offset``) is
below the row's total count. Chunks are slices of the matrix itself, so no
pad column ever exists (the JAX package pads the last chunk and masks it).

Two scans share that contract:

* :func:`scan_time_chunks` — the matrix is on the device; chunks are its
  column slices.
* :class:`HostChunkStreamer` / :func:`stream_host_chunks` — the matrix stays
  in host memory and each time chunk is copied to the device on its own, so
  device memory holds the state plus two chunks. On the card the copies run
  on a side stream from two pinned host buffers into two device buffers, so
  chunk i + 1 is filled and copied while chunk i folds (see the class).

:func:`split_rows` spreads a streamed build's rows over several devices,
each block streaming on its own: the counterpart of the JAX package's chunk
sharding, which is collective-free because every fold is row-local. A
mesh that spans processes hands it the mesh's own split, which gathers
the blocks' results to every rank (`krr_tpu_torch.parallel.fleet`).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Optional, Sequence, TypeVar

import numpy as np
import torch

if TYPE_CHECKING:  # obs.device imports ops (packing), so no import at run time
    from krr_tpu_torch.obs.device import DeviceObs

State = TypeVar("State")

#: Folds that took the generic (non-kernel) path on a CUDA tensor because
#: their mask was not a prefix, per sketch, since :func:`reset_generic_folds`.
GENERIC_FOLDS: dict[str, int] = {"digest": 0, "topk": 0}


def reset_generic_folds() -> None:
    for name in GENERIC_FOLDS:
        GENERIC_FOLDS[name] = 0


def dispatch_prefix_kernel(
    name: str,
    kernel: Callable,
    generic: Callable,
    operands,
    valid: torch.Tensor,
    eff: torch.Tensor,
    mask_is_prefix: bool,
):
    """Shared fold-dispatch for kernels that read the validity mask as a
    per-row prefix length (both sketch families' ``add_chunk``).

    ``mask_is_prefix=True`` is the promise :func:`scan_time_chunks` makes
    by construction: the kernel runs directly. Otherwise the mask is checked
    (one host read), and a mask that is not a prefix takes ``generic`` —
    the JAX package's own dispatch — which on a CUDA tensor counts in
    :data:`GENERIC_FOLDS`."""
    if mask_is_prefix:
        return kernel(operands)
    positions = torch.arange(valid.shape[1], dtype=torch.int32, device=valid.device)
    if bool(torch.equal(valid, positions[None, :] < eff[:, None])):
        return kernel(operands)
    if valid.device.type == "cuda":
        GENERIC_FOLDS[name] += 1
    return generic(operands)


def scan_time_chunks(
    values: torch.Tensor,
    counts: torch.Tensor,
    init: State,
    fold: Callable[[State, torch.Tensor, torch.Tensor], State],
    chunk_size: int,
    time_offset: int = 0,
) -> State:
    """Fold ``fold(state, chunk, valid)`` over ``[N, T]`` in time chunks of
    ``chunk_size`` columns (the last one narrower).

    The fold must be an exact merge (integer adds, maxes, top-K) so the
    result is bit-identical for any chunk size."""
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    t = values.shape[1]
    state = init
    for start in range(0, t, chunk_size):
        chunk = values[:, start : start + chunk_size].contiguous()
        local_pos = torch.arange(start, start + chunk.shape[1], dtype=torch.int64, device=values.device)
        valid = local_pos[None, :] + time_offset < counts[:, None].to(torch.int64)
        state = fold(state, chunk, valid)
    return state


@dataclass
class StreamStats:
    """What host streams did, summed over every pass of every streamer that
    was handed this object. On the card ``copy_seconds`` and
    ``fold_seconds`` are device times between CUDA events (the copies on the
    side stream, the folds on the compute stream); on the CPU there is no
    copy and ``fold_seconds`` is host time. ``copy_wait_seconds`` is host
    time spent waiting for a pinned buffer's previous copy before refilling
    it; ``wall_seconds`` is host time from a pass's first fill to its state
    being ready on the device."""

    passes: int = 0
    chunks: int = 0
    host_bytes: int = 0
    host_fill_seconds: float = 0.0
    copy_wait_seconds: float = 0.0
    copy_seconds: float = 0.0
    fold_seconds: float = 0.0
    wall_seconds: float = 0.0
    pinned_bytes: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)

    @classmethod
    def total(cls, parts) -> "StreamStats":
        """The field-wise sum of ``parts`` (one streamer's stats each)."""
        out = cls()
        for part in parts:
            for name, value in part.__dict__.items():
                setattr(out, name, getattr(out, name) + value)
        return out

    def span_attributes(self) -> dict:
        """The totals a streamed ``quantile`` stage carries: the passes and
        chunks, the host bytes read and the pinned bytes staged, the host
        fill and copy-wait seconds, and the copy and fold device seconds."""
        return {"passes": self.passes, "chunks": self.chunks, "host_bytes": self.host_bytes,
                "pinned_bytes": self.pinned_bytes, "fill_seconds": self.host_fill_seconds,
                "copy_wait_seconds": self.copy_wait_seconds, "copy_seconds": self.copy_seconds,
                "fold_seconds": self.fold_seconds}


#: The span of a streamer handed no ``obs``.
_NO_SPAN = contextlib.nullcontext()


class HostChunkStreamer:
    """Folds over a host ``[N, T]`` numpy matrix, streaming time chunks of
    ``chunk_size`` columns (the last one narrower) to ``device``.

    ``fold(state, chunk, eff)`` gets the ``[N, w]`` float32 chunk on the
    device (contiguous) and ``eff``, the ``[N]`` int32 length of each row's
    valid prefix in the chunk: validity is always a per-row prefix (position
    ``p`` of the chunk starting at column ``s`` is valid iff
    ``s + p + time_offset < counts[i]``), so the folds hand it to the
    kernels as it is and never build a mask. The fold must be an exact merge
    and row-local, so the result is bit-identical to a resident fold for
    any chunk size.

    Each chunk is copied as numpy casts it to float32: the strategies hand
    it windows packed in float32 already (memory in MB, divided in the
    pack's own fill, `krr_tpu_torch.strategies.window`), so the copy keeps
    their bytes.

    On a CUDA device: two pinned host staging buffers and two device chunk
    buffers, allocated at the first :meth:`run` and reused by every later
    one (:meth:`run` may be called any number of times over one matrix, as
    the streamed radix select does four times). Chunk i uses buffer pair
    ``i % 2``. The host fills a pinned buffer only after that buffer's
    previous copy has finished (its copy event); the copy is issued
    ``non_blocking`` on a side stream, after the fold that last read the
    device buffer (its fold event); the fold runs on the caller's current
    stream (every kernel wrapper launches there) after the chunk's copy
    event. So chunk i + 1 is filled on the host and copied while chunk i
    folds on the card. On the CPU the same folds run in the same order, with
    no pinning and no streams. ``stats`` (a :class:`StreamStats`) collects
    the legs.

    With ``obs`` (the strategy's `krr_tpu_torch.obs.device.DeviceObs`) each
    chunk's host fill is a ``stream_fill`` stage carrying its ``bytes`` (the
    host bytes read), and each wait for a pinned buffer's previous copy a
    ``stream_wait`` stage: spans of a recording tracer, nothing otherwise.
    Neither fences the device, so the copies and folds overlap as they do
    untraced."""

    def __init__(
        self,
        values: np.ndarray,
        counts: np.ndarray,
        chunk_size: int,
        time_offset: int = 0,
        *,
        device: "torch.device | str" = "cuda",
        stats: Optional[StreamStats] = None,
        obs: Optional["DeviceObs"] = None,
    ):
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")
        if values.ndim != 2:
            raise ValueError(f"values must be a 2-D host array, got shape {values.shape}")
        self.values = values
        self.n, self.t = values.shape
        counts32 = np.ascontiguousarray(counts, dtype=np.int32)
        if counts32.shape != (self.n,):
            raise ValueError(f"{counts32.shape[0] if counts32.ndim else 0} counts for {self.n} rows")
        self.chunk_size = chunk_size
        self.time_offset = time_offset
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        self.counts = torch.from_numpy(counts32).to(self.device)
        self.num_chunks = -(-self.t // chunk_size) if self.n else 0
        self.stats = StreamStats() if stats is None else stats
        self.obs = obs
        self._pinned: list[torch.Tensor] = []
        self._chunks: list[torch.Tensor] = []
        self._copy_stream: Optional[torch.cuda.Stream] = None

    def _bounds(self, i: int) -> tuple[int, int]:
        start = i * self.chunk_size
        return start, min(start + self.chunk_size, self.t)

    def _stage(self, name: str, **attributes):
        return _NO_SPAN if self.obs is None else self.obs.stage(name, **attributes)

    def _eff(self, start: int, width: int) -> torch.Tensor:
        """Per-row valid prefix length of the chunk starting at ``start``."""
        return torch.clamp(self.counts - (self.time_offset + start), 0, width).to(torch.int32)

    def _fill(self, i: int, out: np.ndarray) -> None:
        """Write chunk i, cast to float32, into ``out`` ([N, w])."""
        start, end = self._bounds(i)
        block = self.values[:, start:end]
        nbytes = block.size * block.itemsize
        with self._stage("stream_fill", bytes=nbytes):
            started = time.perf_counter()
            np.copyto(out, block, casting="unsafe")  # numpy's float32 cast, or a plain copy
            self.stats.host_fill_seconds += time.perf_counter() - started
        self.stats.host_bytes += nbytes

    def run(self, init: State, fold: Callable[[State, torch.Tensor, torch.Tensor], State]) -> State:
        """One full pass: fold every chunk into ``init``; returns the state
        (on the device, its folds finished)."""
        if self.n == 0 or self.t == 0:
            return init
        started = time.perf_counter()
        if self.device.type == "cuda":
            state = self._run_cuda(init, fold)
        else:
            state = self._run_cpu(init, fold)
        self.stats.passes += 1
        self.stats.chunks += self.num_chunks
        self.stats.wall_seconds += time.perf_counter() - started
        return state

    def _run_cpu(self, state: State, fold) -> State:
        for i in range(self.num_chunks):
            start, end = self._bounds(i)
            chunk = np.empty((self.n, end - start), dtype=np.float32)
            self._fill(i, chunk)
            folded = time.perf_counter()
            state = fold(state, torch.from_numpy(chunk), self._eff(start, end - start))
            self.stats.fold_seconds += time.perf_counter() - folded
        return state

    def _buffers(self) -> None:
        """The two pinned staging buffers and the two device chunk buffers,
        flat, each as large as the widest chunk (allocated once)."""
        if self._chunks:
            return
        size = self.n * min(self.chunk_size, self.t)
        self._pinned = [torch.empty(size, dtype=torch.float32, pin_memory=True) for _ in range(2)]
        self._chunks = [torch.empty(size, dtype=torch.float32, device=self.device) for _ in range(2)]
        self._copy_stream = torch.cuda.Stream(self.device)
        self.stats.pinned_bytes += 2 * 4 * size  # and as many device bytes

    def _run_cuda(self, state: State, fold) -> State:
        self._buffers()
        compute = torch.cuda.current_stream(self.device)
        copy_stream = self._copy_stream
        copied: list = [None, None]  # per buffer pair: its last copy's event
        folded: list = [None, None]  # per buffer pair: its last fold's end event
        timings = []
        for i in range(self.num_chunks):
            slot = i % 2
            start, end = self._bounds(i)
            size = self.n * (end - start)
            if copied[slot] is not None:  # the pinned buffer is still being read
                with self._stage("stream_wait"):
                    waited = time.perf_counter()
                    copied[slot].synchronize()
                    self.stats.copy_wait_seconds += time.perf_counter() - waited
            pinned = self._pinned[slot][:size]
            self._fill(i, pinned.numpy().reshape(self.n, end - start))
            chunk = self._chunks[slot][:size]
            with torch.cuda.stream(copy_stream):
                if folded[slot] is not None:  # the device buffer is still being folded
                    copy_stream.wait_event(folded[slot])
                copy_start = torch.cuda.Event(enable_timing=True)
                copy_start.record(copy_stream)
                chunk.copy_(pinned, non_blocking=True)
                copied[slot] = torch.cuda.Event(enable_timing=True)
                copied[slot].record(copy_stream)
            compute.wait_event(copied[slot])
            fold_start = torch.cuda.Event(enable_timing=True)
            fold_start.record(compute)
            state = fold(state, chunk.view(self.n, end - start), self._eff(start, end - start))
            folded[slot] = torch.cuda.Event(enable_timing=True)
            folded[slot].record(compute)
            timings.append((copy_start, copied[slot], fold_start, folded[slot]))
        compute.synchronize()
        for copy_start, copy_end, fold_start, fold_end in timings:
            self.stats.copy_seconds += copy_start.elapsed_time(copy_end) / 1e3
            self.stats.fold_seconds += fold_start.elapsed_time(fold_end) / 1e3
        return state


def stream_host_chunks(
    values: np.ndarray,
    counts: np.ndarray,
    init: State,
    fold: Callable[[State, torch.Tensor, torch.Tensor], State],
    chunk_size: int,
    time_offset: int = 0,
    *,
    device: "torch.device | str" = "cuda",
    stats: Optional[StreamStats] = None,
    obs: Optional["DeviceObs"] = None,
) -> State:
    """One-shot convenience wrapper over :class:`HostChunkStreamer`."""
    return HostChunkStreamer(
        values, counts, chunk_size, time_offset=time_offset, device=device, stats=stats, obs=obs
    ).run(init, fold)


def concat_parts(parts: list, device: torch.device):
    """Row blocks' results, in order, as one: host arrays concatenated,
    tensors concatenated on ``device``, tuples (a digest, a sketch) field by
    field."""
    first = parts[0]
    if isinstance(first, np.ndarray):
        return np.concatenate(parts)
    if isinstance(first, torch.Tensor):
        return torch.cat([part.to(device) for part in parts])
    return type(first)(*(concat_parts(list(field), device) for field in zip(*parts)))


def row_blocks(n: int, parts: int) -> list[tuple[int, int]]:
    """``[start, stop)`` of each of ``parts`` row blocks of ``n`` rows:
    ``ceil(n / parts)`` rows each, so the last are shorter and a block
    that would be empty is left out (no rows: no block)."""
    block = max(-(-n // parts), 1)
    return [(start, min(start + block, n)) for start in range(0, n, block)]


#: A row split done elsewhere, called as ``split(values, counts, run)``:
#: a mesh's, whose blocks may lie on other processes
#: (`krr_tpu_torch.parallel.fleet.mesh_row_split`).
RowSplit = Callable[[np.ndarray, np.ndarray, Callable], State]


def split_rows(
    values: np.ndarray,
    counts: np.ndarray,
    devices: "Sequence[torch.device | str] | RowSplit",
    run: Callable[[np.ndarray, np.ndarray, torch.device], State],
) -> State:
    """``run(values block, counts block, device)`` over row blocks of a host
    ``[N, T]`` matrix, one block per device, and the results gathered in
    row order (tensors onto the first device). The JAX package pads the
    rows to a multiple of the device count and gives each device an equal
    block (`krr_tpu/ops/chunked.py` ``HostChunkStreamer`` with a
    ``sharding``); here each device takes ``ceil(N / D)`` rows without the
    pad (:func:`row_blocks`), so the last blocks are shorter or empty, and
    an empty block runs nowhere. One device runs the whole matrix and its
    result is returned as it is. ``devices`` are this process's; a
    :data:`RowSplit` in their place splits the rows itself."""
    if callable(devices):
        return devices(values, counts, run)
    devices = [torch.device(d) for d in devices]
    parts = [run(values[start:stop], counts[start:stop], device)
             for (start, stop), device in zip(row_blocks(values.shape[0], len(devices)), devices)]
    if len(parts) <= 1:
        return parts[0] if parts else run(values, counts, devices[0])
    return concat_parts(parts, devices[0])
