"""Build the port's CUDA kernels from ``csrc/*.cu`` and load them.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, which Python loads with ``ctypes``.
Nothing includes PyTorch's headers, so a build takes seconds, not the
minutes a ``torch.utils.cpp_extension`` build would. Libraries go to
``build/kernels/`` at the root of the checkout, named by a digest of the
source and the flags, so an edited source is rebuilt and an unchanged one
is reused. ``build()`` starts one ``nvcc`` per source, all at once.

Failures raise :class:`KernelBuildError`; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["KernelBuildError", "KERNEL_SOURCES", "BUILD_DIR", "NVCC_FLAGS",
           "build", "load", "check_operand", "check_launch"]

CSRC = Path(__file__).resolve().with_name("csrc")
#: root of the checkout (src/repro_torch/kernels/_build.py -> parents[3])
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
#: every kernel library of the port, by name (csrc/<name>.cu)
KERNEL_SOURCES = ("lfvt_walk", "bitmap_join", "onehot_join",
                  "flash_attention")

_LOADED: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or (
        "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError(
        "nvcc not found (not on PATH, nor under $CUDA_HOME/bin); the CUDA "
        "kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Where ``name``'s library lives: keyed by a digest of the source
    text, the shared headers (``csrc/*.cuh``) and the compiler flags."""
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise KernelBuildError(f"no kernel source {src}")
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNEL_SOURCES, extra_flags=(),
          logs: dict | None = None) -> dict[str, float]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns the seconds each
    build took (0.0 for one already built). ``extra_flags`` (for example
    ``("-Xptxas", "-v")`` to print register use) are appended to the
    compile command without changing the library's name; ``logs``, when
    given, receives each compiled source's ``nvcc`` output by name."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    took = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            took[name] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if log.strip():
            print(f"[nvcc {name}]\n{log.rstrip()}", flush=True)
        if logs is not None:
            logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: concurrent builders agree
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib


def check_operand(who: str, name: str, x, shape, device, dtype) -> None:
    """Raise ``ValueError`` unless ``x`` lies on ``device`` with ``dtype``,
    ``shape`` and a contiguous layout: what every kernel's C entry point
    assumes of its pointers."""
    if x.device != device:
        raise ValueError(f"{who}: {name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        want = str(dtype).removeprefix("torch.")
        raise ValueError(f"{who}: {name} must be {want}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{who}: {name} is not contiguous")


def check_launch(who: str, err: int) -> None:
    """Raise unless a C entry point's ``cudaGetLastError()`` was 0."""
    if err != 0:
        raise RuntimeError(f"{who}: CUDA launch failed with error {err}")
