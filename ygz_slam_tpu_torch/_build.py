"""Builds the CUDA kernels in `csrc/` with nvcc, at first use and only then.

Each `csrc/<name>.cu` becomes its own shared library with a plain C
interface, loaded with ctypes.  All sources are compiled together, one
nvcc process each, started at once.  Outputs go to `_build/<hash>/`
(listed in .gitignore); the hash covers every source, header and flag, so
a build is reused while they are unchanged and redone when they change.
A failed build raises with nvcc's output; a good one keeps it beside the
library (`lib<name>.log`: ptxas's registers, stack and spills of every
kernel, read by `kernel_resources`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
# -fmad=false: no multiply-add contraction.  Each product and sum rounds on
# its own, as in the plain versions' PyTorch operations, so a kernel's
# per-point decisions (a window's or image margin's edge, cheirality, an
# inlier test, a bisection count) on the same inputs are the plain
# version's bit for bit, and only the order of its block sums differs.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# Seconds the last build took (0.0 when every library was reused).
last_build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source whose library is missing; returns the
    build directory.  Raises if any nvcc fails."""
    global last_build_seconds
    out = _build_dir()
    todo = [s for s in sources() if not (out / f"lib{s.stem}.so").exists()]
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        tmp = out / f"lib{src.stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src.name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            (out / f"lib{src.stem}.log").write_text(log)
            os.replace(tmp, out / f"lib{src.stem}.so")
    last_build_seconds = time.perf_counter() - t0
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<name>.cu` (building all
    sources first if needed)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
            _libs[name] = lib
        return lib


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def kernel_resources(name: str) -> dict[str, dict[str, int]]:
    """ptxas's report on each kernel (entry function, by mangled name) of
    csrc/<name>.cu in the current build: registers per thread, stack frame,
    spill stores / loads and static shared memory in bytes."""
    out: dict[str, dict[str, int]] = {}
    entry = None
    for line in (build_all() / f"lib{name}.log").read_text().splitlines():
        m = _ENTRY.search(line)
        if m:
            entry = m.group(1)
            out[entry] = {}
            continue
        if entry is None:
            continue
        m = _FRAME.search(line)
        if m and "stack" not in out[entry]:
            out[entry].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m:
            out[entry]["registers"] = int(m.group(1))
            m = _SMEM.search(line)
            out[entry]["smem"] = int(m.group(1)) if m else 0
            entry = None
    return out
