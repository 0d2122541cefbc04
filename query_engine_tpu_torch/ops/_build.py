"""Build and load the port's CUDA kernels.

The sources in `query_engine_tpu_torch/csrc/*.cu` have a plain C interface.
At first use, `load_library()` compiles them with nvcc for Hopper
(`sm_90a`), one nvcc process per source, all started together, and links
the objects into one shared library under `query_engine_tpu_torch/_build/`,
named by a hash of the sources and the headers beside them (`*.cuh`); it
loads the library with ctypes. A build that exists is reused. When nvcc is missing or fails, the call raises with the
compiler's output; nothing falls back to another implementation. The
threads of one process build and load it once, under a lock (a mesh's
shard threads may all launch a kernel first at once).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


@dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # nvcc wall time; 0.0 when an existing build was loaded
    log: str        # nvcc's output (ptxas register and shared-memory use)


_built: Optional[Built] = None
_build_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels of query_engine_tpu_torch cannot be built"
    )


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    f = lib.qe_group_agg
    f.argtypes = [p, i32, i64, i32, i32, p, p, p, p, p, p, p]
    f.restype = i32
    for f in (lib.qe_small_gather_u32, lib.qe_small_gather_planes):
        f.argtypes = [p, p, i64, i32, i32, p, p]
        f.restype = i32
    f = lib.qe_onehot_bytes
    f.argtypes = [p, p, p, p, i64, p, p]
    f.restype = i32
    f = lib.qe_onehot_factorized
    f.argtypes = [p, p, p, i64, i32, p, p]
    f.restype = i32
    f = lib.qe_onehot_s8
    f.argtypes = [p, p, p, i64, i32, p, p]
    f.restype = i32
    f = lib.qe_hash_build
    f.argtypes = [p, p, i64, i32, p, p, i64, p, p]
    f.restype = i32
    f = lib.qe_hash_probe
    f.argtypes = [p, p, i64, p, p, i64, i32, p, p, p]
    f.restype = i32


def load_library() -> Built:
    """Build (if needed) and load the kernel library; cached per process."""
    if _built is not None:
        return _built
    with _build_lock:
        return _built if _built is not None else _load()


def _load() -> Built:
    global _built
    sources = sorted(SRC_DIR.glob("*.cu"))
    h = hashlib.sha256()
    for src in sorted([*sources, *SRC_DIR.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libqe_kernels_{h.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        nvcc = _nvcc()
        t0 = time.perf_counter()
        objs = [tmp.with_name(f"{tmp.stem}.{src.stem}.o") for src in sources]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                for src, o in zip(sources, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [p.communicate()[0] for p in procs]
        cmds.append([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                     *map(str, objs)])
        if all(p.returncode == 0 for p in procs):
            link = subprocess.run(cmds[-1], capture_output=True, text=True)
            procs.append(link)
            logs.append(link.stdout + link.stderr)
        for o in objs:
            o.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        log = "".join(logs)
        for cmd, p, out_log in zip(cmds, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed with exit code {p.returncode}:\n"
                    f"{' '.join(cmd)}\n{out_log}"
                )
        os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    lib = ctypes.CDLL(str(out))
    _bind(lib)
    _built = Built(lib, out, seconds, log)
    return _built
