"""Build and load the port's CUDA kernels (``sduss_tpu_torch/csrc/*.cu``).

Route: ``nvcc`` compiles every source in ``csrc/`` for ``sm_90a`` — one
``nvcc`` process per source, all started together — and links the objects
into one shared library with a plain C interface, loaded with ctypes.  No
PyTorch headers, so a build takes seconds.  The library lands in
``build/sduss_tpu_torch/`` at the repository root, named by a hash of the
sources and flags: a changed source rebuilds, an unchanged one reuses the
file.  Nothing is built or loaded until a kernel is first launched on a
CUDA tensor; the CPU path never calls into this module.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch

from sduss_tpu_torch import tracing

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "sduss_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-lineinfo", "-Xptxas", "-v", "-Xcompiler", "-fPIC"]
_TIMEOUT_S = 900


def _sources():
    srcs = sorted(SRC_DIR.glob("*.cu"))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources in {SRC_DIR}")
    return srcs


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are compiled from source at first use")


def library_path() -> Path:
    """Path of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(SRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsduss_kernels_{h.hexdigest()[:16]}.so"


class Build(NamedTuple):
    path: Path
    seconds: float  # 0.0: an existing library was reused
    log: str        # nvcc output, including ptxas register/smem usage


def _run_all(cmds) -> str:
    """Run the commands concurrently; raise on the first that fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs, failed = [], []
    try:
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate(timeout=_TIMEOUT_S)
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)} -> {proc.returncode}:\n{out}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "".join(logs)


def build() -> Build:
    """Compile the sources unless a library for them already exists."""
    path = library_path()
    if path.exists():
        return Build(path, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tracing.span("kernel.build"), \
            tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        nvcc = _nvcc()
        objs = [os.path.join(tmpdir, src.stem + ".o") for src in _sources()]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                        for src, obj in zip(_sources(), objs)])
        tmp = os.path.join(tmpdir, path.name)
        log += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, path)
    return Build(path, time.perf_counter() - t0, log)


def _kernel_name(mangled: str) -> str:
    """The ``*kernel`` identifier in a mangled name, where names are
    length-prefixed ("16mha_fused_kernel") and may follow a hash's digits."""
    for i, ch in enumerate(mangled):
        m = re.match(r"\d+", mangled[i:]) if ch.isdigit() else None
        if m:
            n = int(m.group())
            ident = mangled[m.end() + i:m.end() + i + n]
            if len(ident) == n and ident.endswith("kernel"):
                return ident
    return mangled


def ptxas_usage(log: str) -> list:
    """Per kernel of an nvcc log: registers, spill bytes and shared memory.

    ptxas prints, per entry function, "Compiling entry function '<mangled>'",
    then "N bytes stack frame, N bytes spill stores, N bytes spill loads" and
    "Used N registers, ... N bytes smem".  Template arguments of the mangled
    name are spelled out for the kernels of this package (``Li64E`` = 64,
    ``Lb1E`` = true).
    """
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            args = re.findall(r"L([ib])(\d+)E", mangled)
            cur = {"kernel": _kernel_name(mangled) + (
                "<" + ", ".join(v if t == "i" else ("true" if v == "1" else
                                                     "false")
                                for t, v in args) + ">" if args else ""),
                   "registers": None, "spill_stores": None,
                   "spill_loads": None, "smem": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(smem.group(1)) if smem else 0
    return out


_COUNT_LOCK = threading.Lock()
_LOAD_LOCK = threading.Lock()


def count(fn, n: int = 1) -> None:
    """Add ``n`` to a kernel wrapper's ``launches`` counter, and to the
    launching thread's in ``fn.by_thread`` (a group's shards launch from
    threads of their own, ``shard-<rank>_*``)."""
    with _COUNT_LOCK:
        fn.launches += n
        by = fn.__dict__.setdefault("by_thread", {})
        name = threading.current_thread().name
        by[name] = by.get(name, 0) + n


@contextlib.contextmanager
def stream_for(device):
    """Yield the raw handle of ``device``'s current CUDA stream, with
    ``device`` the current device while the block runs: a launch and a
    kernel's shared-memory attribute act on the current device (a replica
    on another card).  On the current device the handle is read directly,
    without building a ``torch.cuda.Stream`` (about 11 us less a launch,
    measured on an H100)."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        yield torch._C._cuda_getCurrentRawStream(index)
    else:
        with torch.cuda.device(index):
            yield torch._C._cuda_getCurrentRawStream(index)


def load_library() -> ctypes.CDLL:
    """Build if needed, load once (whichever thread asks first), and
    declare every entry point's types."""
    with _LOAD_LOCK:
        return _load()


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build().path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sduss_flash_mha_fused.argtypes = [p, p, p, p, i, i, i, i, i,
                                          ctypes.c_float, p]
    lib.sduss_flash_mha_fused.restype = ctypes.c_int
    lib.sduss_flash_mha.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                    ctypes.c_float, p]
    lib.sduss_flash_mha.restype = ctypes.c_int
    lib.sduss_flash_mha_masked.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                           ctypes.c_float, p]
    lib.sduss_flash_mha_masked.restype = ctypes.c_int
    lib.sduss_flash_cross_short.argtypes = [p, p, p, p, i, i, i, i, i,
                                            ctypes.c_float, p]
    lib.sduss_flash_cross_short.restype = ctypes.c_int
    lib.sduss_gn_silu_halo.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                                       p]
    lib.sduss_gn_silu_halo.restype = ctypes.c_int
    lib.sduss_gn_dense.argtypes = [p, p, p, p, i, p, p, i, i, i, i, i, i, i,
                                   i, i, ctypes.c_float, ctypes.c_uint, i, p]
    lib.sduss_gn_dense.restype = ctypes.c_int
    lib.sduss_gn_dense_cluster.argtypes = [p, p, p, p, i, p, i, i, i, i, i,
                                           i, i, ctypes.c_float,
                                           ctypes.c_uint, i, p]
    lib.sduss_gn_dense_cluster.restype = ctypes.c_int
    lib.sduss_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sduss_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.sduss_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
