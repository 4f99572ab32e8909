"""Shared time-axis chunk scan for mergeable sketch builds.

Port of the resident half of `krr_tpu/ops/chunked.py`. Both sketch families
(log-bucket digest, exact top-K) can fold a packed ``[N, T]`` matrix chunk by
chunk into a fixed-size state, and the validity contract lives here, once: a
position is valid iff it is inside this array's real width AND its *global*
position (local + ``time_offset``) is below the row's total count. The
sharded and host-streamed builds pass a per-shard ``time_offset``; chunks
here are slices of the array itself, so no pad column ever exists.

The host-streamed fold (``HostChunkStreamer``) waits for ROADMAP M6.
"""

from __future__ import annotations

from typing import Callable, TypeVar

import torch

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
