"""Build, load and launch the port's CUDA kernels.

Each kernel is one ``.cu`` file with a plain C entry point, compiled by
``nvcc`` for ``sm_90a`` into its own shared library and loaded with
``ctypes``.  Libraries go to ``build/kernels/`` at the repository root,
named by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused.  Nothing is built at import
time: ``load`` builds on first use, ``build_all`` builds every kernel at
once (one ``nvcc`` per source, all started together).  A kernel's launch
constants come from ``segmin/plan.py: CUDA_CONSTANTS`` as ``-D`` flags
(``flags``), so the host's plan and the kernel share one definition.
``check_tensors`` and ``launch`` are what every wrapper shares: the
checks of device, dtype, shape and contiguity, and the launch on the
current stream that raises on a non-zero ``cudaError_t``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"

# kernel name -> CUDA source
SOURCES: Dict[str, Path] = {
    "owner_scatter_min": _PKG / "segmin" / "csrc" / "owner_scatter_min.cu",
    "segmin_candidates": _PKG / "segmin" / "csrc" / "segmin_candidates.cu",
    "relabel": _PKG / "relabel" / "csrc" / "relabel.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (neither on PATH nor under "
                       "CUDA_HOME): the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def flags(name: str) -> Tuple[str, ...]:
    """``nvcc`` flags of kernel ``name``: ``NVCC_FLAGS`` and a ``-D`` flag
    for each of its constants in ``plan.CUDA_CONSTANTS``."""
    from repro_torch.kernels.segmin.plan import CUDA_CONSTANTS
    return NVCC_FLAGS + tuple(
        f"-D{k}={v}" for k, v in CUDA_CONSTANTS.get(name, {}).items())


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's output (``ptxas`` register and spill report) of
    the last build of ``name``, or "" when it was not built here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build every missing library, all ``nvcc`` processes at once.

    Returns the seconds each build took (0.0 for one already built).
    Raises with the compiler's output when a build fails.
    """
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags(name), "-o", str(tmp), str(SOURCES[name])]
        todo[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, t0) in todo.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def check_tensors(fn: str, want: Dict[str, Tuple[torch.Tensor, torch.dtype]],
                  shape: Optional[torch.Size] = None) -> None:
    """Raise unless every ``name: (tensor, dtype)`` has that dtype (a
    ``TypeError``), is contiguous and lies on the first one's device,
    and, where ``shape`` is given, has that shape (``ValueError``)."""
    device = next(iter(want.values()))[0].device
    for name, (t, dtype) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
        if shape is not None and t.shape != shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.device != device:
            raise ValueError(f"{fn}: {name} is on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


def launch(name: str, argtypes: Sequence, device: torch.device,
           *args) -> None:
    """Call kernel ``name``'s C entry point ``<name>_launch`` with
    ``args`` (of ``argtypes``) and ``device``'s current stream; raise on
    the non-zero ``cudaError_t`` it returns (a refused launch never runs,
    and a later synchronise would not report it)."""
    fn = getattr(load(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t "
                           f"{err}")
