"""msfbench: the benchmark of repro_torch, the PyTorch and CUDA port."""
from __future__ import annotations

import functools
import importlib.util
import sys
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent


@functools.lru_cache(maxsize=None)
def by_name(folder: str, name: str) -> ModuleType:
    """The module of ``msfbench/<folder>/<name>.py``: a metric's reader,
    a traffic driver or a graph family, found by the name that
    ``BENCHMARK.json`` or a data file gives it."""
    path = BENCH_DIR / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder}/{name}.py in the benchmark")
    tag = "".join(c if c.isalnum() else "_" for c in f"{folder}_{name}")
    spec = importlib.util.spec_from_file_location("msfbench_" + tag, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # a dataclass looks its module up there
    spec.loader.exec_module(mod)
    return mod
