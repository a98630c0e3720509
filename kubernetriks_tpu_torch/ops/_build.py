"""Build and load the port's CUDA kernels.

Each `.cu` source under ops/csrc/ compiles with nvcc into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), loaded with ctypes; the `.cuh` headers there hold device code
the sources share. All sources compile at once, one nvcc process each,
into ops/build/ (listed in .gitignore), named by a hash of the source, the
headers and the flags so an edited source or header rebuilds. Nothing is built on import: the
first launch (or `build_all()`) builds.

Flags: sm_90a (Hopper), -O3, and --fmad=false so no multiply-add is
contracted into an FMA the reference does not do. No fast math: float
division stays IEEE.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "--fmad=false", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

# kernel name -> (source file, C entry point, argument types).
_P = ctypes.c_void_p
_I = ctypes.c_int
KERNELS: Dict[str, Tuple[str, str, List]] = {
    "event_scatter": (
        "event_scatter.cu", "ktt_event_scatter", [_P] * 15 + [_I] * 4 + [_P],
    ),
    "free_resources": (
        "free_resources.cu", "ktt_free_resources", [_P] * 13 + [_I] * 3 + [_P],
    ),
    "select_cycle_commit": (
        "select_cycle_commit.cu", "ktt_select_cycle_commit", [_P] * 23 + [_I] * 6 + [_P],
    ),
    "ca_scale_down": (
        "ca_scale_down.cu", "ktt_ca_scale_down", [_P] * 16 + [_I] * 7 + [_P],
    ),
    "ca_scale_up": (
        "ca_scale_up.cu", "ktt_ca_scale_up", [_P] * 14 + [_I] * 4 + [_P],
    ),
    "schedule_cycle": (
        "schedule_cycle.cu", "ktt_schedule_cycle", [_P] * 12 + [_I] * 5 + [_P],
    ),
    "select_schedule_cycle": (
        "select_schedule_cycle.cu", "ktt_select_schedule_cycle", [_P] * 17 + [_I] * 6 + [_P],
    ),
    "commit_scatter": (
        "commit_scatter.cu", "ktt_commit_scatter", [_P] * 12 + [_I] * 3 + [_P],
    ),
    # The chaos engine's commit-time draw: glue, no TPU kernel of the
    # reference's (ops/chaos_kernel.py).
    "pod_attempt_draw": (
        "pod_attempt_draw.cu", "ktt_pod_attempt_draw", [_P] * 9 + [_I] * 7 + [_P],
    ),
    # The window executor's glue (ops/window_kernel.py): no TPU kernels.
    "window_work_due": (
        "window_work_due.cu", "ktt_window_work_due", [_P] * 11 + [_I] * 4 + [_P],
    ),
    "next_window": (
        "next_window.cu", "ktt_next_window", [_P] * 20 + [_I] * 9 + [_P],
    ),
    "catch_up": (
        "catch_up.cu", "ktt_catch_up", [_P] * 19 + [_I] * 4 + [_P],
    ),
    "conditional_wake": (
        "conditional_wake.cu", "ktt_conditional_wake", [_P] * 8 + [_I] * 3 + [_P],
    ),
    # The flight recorder's record (ops/telemetry_kernel.py): no TPU kernel.
    "telemetry_record": (
        "telemetry_record.cu", "ktt_telemetry_record", [_P] * 22 + [_I] * 7 + [_P],
    ),
}

# Launch plumbing that is no kernel of the reference's: name -> the same
# triple (the last pointer the stream). graph_if: a conditional node in a
# capturing graph (graphs.py).
HELPERS: Dict[str, Tuple[str, str, List]] = {
    "graph_if": ("graph_if.cu", "ktt_graph_if", [_P] * 3),
}
_SOURCES = {**KERNELS, **HELPERS}

_loaded: Dict[str, ctypes._CFuncPtr] = {}
build_log: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the shared
    headers it may include and the flags."""
    src = (CSRC / _SOURCES[name][0]).read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all() -> float:
    """Compile every kernel and helper whose library is missing, all nvcc
    processes started together. Returns the wall seconds spent; raises
    with nvcc's output if any build fails."""
    t0 = time.perf_counter()
    todo = [n for n in _SOURCES if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / _SOURCES[name][0])]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def kernel(name: str):
    """The C entry point of kernel or helper `name` (built on first use).
    Its arguments are device pointers and ints as in KERNELS (HELPERS),
    then the CUDA stream; it returns a cudaError_t (a kernel's:
    cudaGetLastError() after the launch)."""
    fn = _loaded.get(name)
    if fn is None:
        build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        _, symbol, argtypes = _SOURCES[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn
