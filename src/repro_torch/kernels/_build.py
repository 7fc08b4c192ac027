"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` file is one shared library with a plain C interface,
compiled for Hopper (``sm_90a``) into ``build/kernels/`` at the root of
the checkout (git-ignored) on first use.  The library name carries a hash
of its source, of every ``csrc/*.cuh`` header and of the flags, so an
edited source or header is rebuilt and a built one is loaded as it is.  One ``nvcc`` process per source, all started
together.  Nothing here runs at import time.  The arrival counters that
some kernels' last blocks use are kept here too, one set per stream.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# libraries loaded in this process, by source stem
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def library_path(src: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source not built yet, all in parallel.  Returns
    ``{stem: library path}``; raises with the compiler output when a
    build fails.  Each build's log (``-Xptxas -v``: registers, shared
    memory, spills) lands beside its library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    running = []
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in running:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name}:\n{log}")
        else:
            os.replace(tmp, out)   # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("\n".join(failed))
    return {src.stem: library_path(src) for src in sources}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    lib = _LOADED.get(stem)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[stem]))
        _LOADED[stem] = lib
    return lib


# arrival counters of the kernels whose last block merges the others'
# partials, by (device, stream).  That block resets its counters, so
# every launch leaves them at zero and the launches of one stream, which
# run in order, share them; another stream gets its own.
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def arrival_counters(device: torch.device, stream: int,
                     n: int) -> torch.Tensor:
    """At least ``n`` int32 counters on ``device``, zero between
    launches, for the launches of ``stream``."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf
