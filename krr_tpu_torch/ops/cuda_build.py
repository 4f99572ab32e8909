"""Build and load the port's hand-written CUDA kernels.

Each ``krr_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``. The
build happens at first use (or up front through :func:`build_all`, which
starts one ``nvcc`` per source, all at once) into ``csrc/build/``, a
directory git ignores. The library's file name carries a hash of its source,
of every shared header (``csrc/*.cuh``) and of the flags, so an edited source
or header never loads a stale build; a finished build is moved into place
atomically, so concurrent builds cannot tear it.

Nothing here runs at import time: the CPU-only test environment has no
``nvcc`` and imports every module.

A build is the port's compile: listeners in :data:`BUILD_HOOKS` hear of
each one (`krr_tpu_torch.obs.device.install_compile_hooks` registers the
metrics listener there, so this module imports nothing of ``obs``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

SOURCE_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = SOURCE_DIR / "build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}

#: Build listeners, each called as ``hook(event, seconds)``: ``"compile"``
#: with the wall of one :func:`build_all` call that ran nvcc, ``"miss"``
#: once per source it compiled, ``"hit"`` when :func:`load` finds the
#: hashed library already built.
BUILD_HOOKS: list = []


def _fire(event: str, seconds: float = 0.0) -> None:
    for hook in list(BUILD_HOOKS):
        hook(event, seconds)


def sources() -> list[str]:
    """Kernel source names (``csrc/<name>.cu``), sorted."""
    return sorted(p.stem for p in SOURCE_DIR.glob("*.cu"))


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location. Raises when none exists."""
    candidates = [
        os.path.join(home, "bin", "nvcc")
        for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"))
        if home
    ]
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for candidate in candidates:
        if os.path.isfile(candidate) and os.access(candidate, os.X_OK):
            return candidate
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives: keyed by the source, the
    shared headers it may include and the flags."""
    digest = hashlib.sha256((SOURCE_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SOURCE_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str) -> "tuple[subprocess.Popen, Path, Path]":
    target = library_path(name)
    partial = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(partial), str(SOURCE_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, partial, target


def build_all(names: Optional[list[str]] = None) -> dict[str, dict]:
    """Compile every named source (default: all) that has no current build,
    one ``nvcc`` per source started together. Returns, per source, the
    library path, the build seconds (0 when already built) and the compiler
    output. Raises on the first failed build."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report: dict[str, dict] = {}
    running = []
    started = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            report[name] = {"path": str(target), "seconds": 0.0, "log": ""}
        else:
            running.append((name, *_start(name, nvcc_path())))
    failures = []
    for name, proc, partial, target in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            partial.unlink(missing_ok=True)
            failures.append(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(partial, target)
        report[name] = {"path": str(target), "seconds": time.perf_counter() - started, "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    if running:
        _fire("compile", time.perf_counter() - started)
        for _ in running:
            _fire("miss")
    return report


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed, with
    ``argtypes`` set from ``signatures`` (every entry point returns an int,
    a launch's CUDA error code) and ``krr_error_string`` declared."""
    if name not in _LOADED:
        built = library_path(name).exists()
        build_all([name])
        if built:
            _fire("hit")
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.krr_error_string.argtypes = [ctypes.c_int]
        lib.krr_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return _LOADED[name]


def raise_on_error(lib: ctypes.CDLL, code: int, kernel: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} ({lib.krr_error_string(code).decode()})")
