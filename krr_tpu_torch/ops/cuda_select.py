"""The exact `simple`-strategy device program: CUDA kernels + their wrappers.

Replaces `krr_tpu/ops/pallas_select.py`. Two hand-written kernels
(`krr_tpu_torch/csrc/select.cu`, where each kernel's note says what it
replaces, what bounds it on the card and what its design does about it):

* ``bisect_select`` — per-row exact percentile over the ordered bits: what
  31 bit-space bisection steps pin, found by a radix select, or fewer
  bisection steps when asked for (the JAX package's ``_bisect_kernel``);
* ``row_max`` — per-row NaN-propagating max (``_rowmax_kernel``);
* ``radix_digit_hist`` — one time chunk's histogram of one digit
  (``bits`` wide, at ``shift``) of the ordered bits under each row's
  prefix, added into running ``[N, 2^bits]`` bins: the count pass of the
  host-streamed radix select
  (`krr_tpu_torch.ops.selection.masked_percentile_bisect_from_host`). It
  replaces no Pallas kernel, but the jnp count pass of the JAX package's
  streamed bisection.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else. On a CPU tensor it runs the plain PyTorch version
(`krr_tpu_torch.ops.selection`, `krr_tpu_torch.ops.quantile`, and
:func:`fleet_exact_plain` here); on a CUDA tensor it launches the kernel or
raises — there is no fallback. :data:`LAUNCHES` counts kernel launches per
kernel, so a run can show that it went through the kernels.

The TPU tiling (8-row tiles, 128 lanes, padded copies, a VMEM budget with a
fallback past it) does not carry over: the kernels take any ``N ≥ 0`` and
``T ≥ 0`` as they are.
"""

from __future__ import annotations

import ctypes

import torch

from krr_tpu_torch.ops import cuda_build
from krr_tpu_torch.ops.quantile import masked_max, max_where
from krr_tpu_torch.ops.selection import (
    INT32_MIN,
    MAX_DIGIT_BITS,
    as_ordered_bits,
    masked_percentile_bisect,
    valid_mask,
)

#: Kernel launches per kernel since the last :func:`reset_launches`.
LAUNCHES: dict[str, int] = {"bisect_select": 0, "row_max": 0, "radix_digit_hist": 0}

_SOURCE = "select"
_SIGNATURES = {
    "krr_bisect_select": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ],
    "krr_row_max": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p,
    ],
    "krr_radix_digit_hist": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ],
    "krr_select_cache_ints": [],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    return cuda_build.load(_SOURCE, _SIGNATURES)


def check_rows(values: torch.Tensor, counts: torch.Tensor, what: str) -> None:
    """Raise unless ``values`` is a contiguous 2-D float32 tensor and
    ``counts`` a contiguous 1-D int32 tensor with one count per row, both on
    one CPU or CUDA device — what every kernel of the port takes."""
    if values.dim() != 2 or values.dtype != torch.float32:
        raise TypeError(f"{what}: values must be a 2-D float32 tensor, got {values.dtype} {tuple(values.shape)}")
    if counts.dim() != 1 or counts.dtype != torch.int32:
        raise TypeError(f"{what}: counts must be a 1-D int32 tensor, got {counts.dtype} {tuple(counts.shape)}")
    if counts.shape[0] != values.shape[0]:
        raise ValueError(f"{what}: {counts.shape[0]} counts for {values.shape[0]} rows")
    if values.device != counts.device:
        raise ValueError(f"{what}: values on {values.device} but counts on {counts.device}")
    if values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {values.device}")
    if not (values.is_contiguous() and counts.is_contiguous()):
        raise ValueError(f"{what}: values and counts must be contiguous")
    if values.shape[0] > 2**31 - 1:
        raise ValueError(f"{what}: {values.shape[0]} rows exceed the kernel grid")


def select_cache_ints() -> int:
    """How many ordered bits of a row's head the ``bisect_select`` kernel
    keeps in shared memory; builds the kernel's library on first use."""
    return _library().krr_select_cache_ints()


def _check_iters(num_iters: int) -> None:
    if not 0 <= num_iters <= 31:
        raise ValueError(f"num_iters must be in [0, 31] (31 pins every bit), got {num_iters}")


def _launch_bisect_select(values, counts, q: float, num_iters: int, out: torch.Tensor) -> None:
    lib = _library()
    n, t = values.shape
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        code = lib.krr_bisect_select(
            values.data_ptr(), counts.data_ptr(), out.data_ptr(), n, t, q, num_iters, stream
        )
    cuda_build.raise_on_error(lib, code, "bisect_select")
    LAUNCHES["bisect_select"] += 1


def _launch_row_max(values, counts, out: torch.Tensor) -> None:
    lib = _library()
    n, t = values.shape
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        code = lib.krr_row_max(values.data_ptr(), counts.data_ptr(), out.data_ptr(), n, t, stream)
    cuda_build.raise_on_error(lib, code, "row_max")
    LAUNCHES["row_max"] += 1


def _nan(n: int, device: torch.device) -> torch.Tensor:
    return torch.full((n,), float("nan"), dtype=torch.float32, device=device)


def _row_out(values: torch.Tensor, out: "torch.Tensor | None", what: str) -> torch.Tensor:
    """Where a per-row result of ``values`` goes: ``out`` (checked to be a
    contiguous float32 ``[N]`` tensor on ``values``' device, such as a row
    slice of a larger result) or a fresh tensor."""
    n = values.shape[0]
    if out is None:
        return torch.empty((n,), dtype=torch.float32, device=values.device)
    if out.shape != (n,) or out.dtype != torch.float32 or out.device != values.device or not out.is_contiguous():
        raise ValueError(f"{what}: out must be a contiguous float32 [{n}] tensor on {values.device}")
    return out


def masked_percentile_bisect_cuda(
    values: torch.Tensor, counts: torch.Tensor, q: float, num_iters: int = 31, *, out=None
) -> torch.Tensor:
    """Per-row exact q-th percentile of the valid prefix (NaN for empty
    rows): the ``bisect_select`` kernel on a CUDA tensor, the plain
    ``masked_percentile_bisect`` on a CPU tensor — bit-identical. With
    ``out`` the rows are written there and ``out`` is returned."""
    check_rows(values, counts, "masked_percentile_bisect_cuda")
    _check_iters(num_iters)
    out = _row_out(values, out, "masked_percentile_bisect_cuda")
    n, t = values.shape
    if n == 0 or t == 0:
        return out.fill_(float("nan"))
    if values.device.type == "cpu":
        return out.copy_(masked_percentile_bisect(values, counts, q, num_iters=num_iters))
    _launch_bisect_select(values, counts, q, num_iters, out)
    return out


def masked_max_cuda(values: torch.Tensor, counts: torch.Tensor, *, out=None) -> torch.Tensor:
    """Per-row max of the valid prefix (NaN for empty rows and rows holding
    NaN): the ``row_max`` kernel on a CUDA tensor, the plain ``masked_max``
    on a CPU tensor — bit-identical. With ``out`` the rows are written there
    and ``out`` is returned."""
    check_rows(values, counts, "masked_max_cuda")
    out = _row_out(values, out, "masked_max_cuda")
    n, t = values.shape
    if n == 0 or t == 0:
        return out.fill_(float("nan"))
    if values.device.type == "cpu":
        return out.copy_(masked_max(values, counts))
    _launch_row_max(values, counts, out)
    return out


def fleet_exact_plain(
    cpu_values: torch.Tensor,
    cpu_counts: torch.Tensor,
    mem_values: torch.Tensor,
    mem_counts: torch.Tensor,
    q: float,
    num_iters: int = 31,
) -> torch.Tensor:
    """The plain PyTorch version of :func:`fleet_exact`, on any device."""
    n = cpu_values.shape[0]
    if n == 0:
        return torch.zeros((2, 0), dtype=torch.float32, device=cpu_values.device)
    device = cpu_values.device
    p99 = masked_percentile_bisect(cpu_values, cpu_counts, q, num_iters) if cpu_values.shape[1] else _nan(n, device)
    peak = masked_max(mem_values, mem_counts) if mem_values.shape[1] else _nan(n, device)
    return torch.stack([p99, peak])


def fleet_exact(
    cpu_values: torch.Tensor,
    cpu_counts: torch.Tensor,
    mem_values: torch.Tensor,
    mem_counts: torch.Tensor,
    q: float,
    num_iters: int = 31,
) -> torch.Tensor:
    """The exact `simple`-strategy device program.

    Returns a stacked ``[2, N]`` float32 tensor on the inputs' device — row 0
    the per-container CPU percentile (reference rank semantics, NaN for empty
    rows), row 1 the memory peak — so the host needs exactly one readback.
    On a CUDA device both kernels launch on the current stream straight into
    the two rows of one preallocated tensor. CPU and memory histories may
    have different time extents."""
    check_rows(cpu_values, cpu_counts, "fleet_exact")
    check_rows(mem_values, mem_counts, "fleet_exact")
    _check_iters(num_iters)
    if cpu_values.shape[0] != mem_values.shape[0] or cpu_values.device != mem_values.device:
        raise ValueError("fleet_exact: CPU and memory histories must share rows and device")
    if cpu_values.device.type == "cpu":
        return fleet_exact_plain(cpu_values, cpu_counts, mem_values, mem_counts, q, num_iters)
    n = cpu_values.shape[0]
    out = torch.empty((2, n), dtype=torch.float32, device=cpu_values.device)
    if n == 0:
        return out
    if cpu_values.shape[1]:
        _launch_bisect_select(cpu_values, cpu_counts, q, num_iters, out[0])
    else:
        out[0].fill_(float("nan"))
    if mem_values.shape[1]:
        _launch_row_max(mem_values, mem_counts, out[1])
    else:
        out[1].fill_(float("nan"))
    return out


def row_max_chunk(values: torch.Tensor, eff: torch.Tensor) -> torch.Tensor:
    """Per-row max of the valid prefix ``values[i, :eff[i]]`` (NaN for a row
    holding NaN) with −inf for an empty prefix — the identity of the
    streamed max's combine: the ``row_max`` kernel on a CUDA tensor, the
    plain ``max_where`` on a CPU tensor. ``masked_max_cuda`` answers an
    empty row with NaN instead, which would poison a running max."""
    check_rows(values, eff, "row_max_chunk")
    n, t = values.shape
    if values.device.type == "cpu":
        return max_where(values, valid_mask(eff, t), float("-inf"))
    out = torch.empty((n,), dtype=torch.float32, device=values.device)
    if n == 0:
        return out
    if t == 0:
        return out.fill_(float("-inf"))
    _launch_row_max(values, eff, out)
    return torch.where(eff > 0, out, torch.full_like(out, float("-inf")))


def _check_digit_args(values, eff, prefixes, bins, shift: int, bits: int) -> None:
    check_rows(values, eff, "radix_digit_hist")
    if not 1 <= bits <= MAX_DIGIT_BITS or shift < 0 or shift + bits > 32:
        raise ValueError(
            f"radix_digit_hist: need 1 <= bits <= {MAX_DIGIT_BITS}, shift >= 0 and shift + bits <= 32, "
            f"got shift {shift}, bits {bits}"
        )
    n = values.shape[0]
    if prefixes.dtype != torch.int32 or tuple(prefixes.shape) != (n,) or not prefixes.is_contiguous():
        raise TypeError(f"radix_digit_hist: prefixes must be a contiguous [{n}] int32 tensor")
    if bins.dtype != torch.int32 or tuple(bins.shape) != (n, 1 << bits) or not bins.is_contiguous():
        raise TypeError(f"radix_digit_hist: bins must be a contiguous [{n}, {1 << bits}] int32 tensor")
    if prefixes.device != values.device or bins.device != values.device:
        raise ValueError("radix_digit_hist: values, prefixes and bins must share a device")


def radix_digit_hist_plain(
    values: torch.Tensor, eff: torch.Tensor, prefixes: torch.Tensor, bins: torch.Tensor, shift: int, bits: int
) -> torch.Tensor:
    """The plain PyTorch version of :func:`radix_digit_hist`, on any device:
    the digits of the matching valid keys, masked, ``scatter_add_`` into
    ``bins`` (in place; returned)."""
    if values.shape[0] == 0 or values.shape[1] == 0:
        return bins
    u = (as_ordered_bits(values) ^ INT32_MIN).to(torch.int64) & 0xFFFFFFFF  # signed order -> unsigned
    mask = (0xFFFFFFFF << (shift + bits)) & 0xFFFFFFFF  # the bits above the digit
    prefix = prefixes.to(torch.int64) & mask
    match = valid_mask(eff, values.shape[1]) & ((u & mask) == prefix[:, None])
    return bins.scatter_add_(1, (u >> shift) & ((1 << bits) - 1), match.to(torch.int32))


def radix_digit_hist(
    values: torch.Tensor, eff: torch.Tensor, prefixes: torch.Tensor, bins: torch.Tensor, shift: int, bits: int
) -> torch.Tensor:
    """Add one time chunk into the running digit histogram ``bins``
    (``[N, 2^bits]`` int32, in place; returned): for each row, digit
    ``(u >> shift) & (2^bits - 1)`` of every key ``u = ordered_bits ^
    0x80000000`` of the valid prefix ``values[i, :eff[i]]`` whose bits
    above ``shift + bits`` equal those of ``prefixes[i]`` (the bits of a
    u-prefix, as int32). ``1 <= bits <= 12``, ``shift >= 0`` and ``shift +
    bits <= 32``. The ``radix_digit_hist`` kernel on a CUDA tensor, the
    plain version on a CPU tensor — bit-identical."""
    _check_digit_args(values, eff, prefixes, bins, shift, bits)
    if values.device.type == "cpu":
        return radix_digit_hist_plain(values, eff, prefixes, bins, shift, bits)
    n, t = values.shape
    if n == 0 or t == 0:
        return bins
    lib = _library()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        code = lib.krr_radix_digit_hist(
            values.data_ptr(), eff.data_ptr(), prefixes.data_ptr(), bins.data_ptr(), n, t, shift, bits, stream
        )
    cuda_build.raise_on_error(lib, code, "radix_digit_hist")
    LAUNCHES["radix_digit_hist"] += 1
    return bins
