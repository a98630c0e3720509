"""ctypes binding for the native C++ trace feeder (trace/native/trace_feeder.cc).

Own copy of the JAX package's `trace/feeder.py`: the feeder parses the
Alibaba v2017 CSVs (batch_instance joined to batch_task; machine_events),
applies the Rust simulator's validity filters
(src/trace/alibaba_cluster_trace_v2017/workload.rs:56-120, cluster.rs:55-105)
and returns dense, time-sorted numpy arrays, which
batched/trace_compile.compile_from_arrays compiles without per-event
Python objects. The Python pipeline in trace/alibaba.py has the same
semantics and is both the fall-back where no C++ toolchain exists and the
oracle of the tests.

The shared library is built with g++ at first use into trace/build/
(listed in .gitignore), named by a hash of the source and the flags, so an
edited source rebuilds; it is built to a per-process temporary file and
renamed into place, so concurrent builders (test workers, parallel CLI
runs) never load a half-written library. Nothing is built on import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_SOURCE = Path(__file__).resolve().parent / "native" / "trace_feeder.cc"
_BUILD_DIR = Path(__file__).resolve().parent / "build"
_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"libtrace_feeder_{digest}.so"


def _build_library() -> Optional[str]:
    """Compile the feeder unless its library exists. Returns an error
    string or None."""
    try:
        if not _SOURCE.exists():
            return f"feeder source not found: {_SOURCE}"
        lib = library_path()
        if lib.exists():
            return None
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    except OSError as exc:
        return f"cannot stage the native build directory: {exc}"
    tmp = lib.with_name(f"{lib.name}.tmp.{os.getpid()}")
    try:
        proc = subprocess.run(
            ["g++", *_FLAGS, str(_SOURCE), "-o", str(tmp)], capture_output=True, text=True, timeout=300
        )
        if proc.returncode != 0:
            return f"g++ failed: {proc.stderr[-2000:]}"
        os.replace(tmp, lib)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"g++ invocation failed: {exc}"
    finally:
        if tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        err = _build_library()
        if err is not None:
            _build_error = err
            return None
        lib = ctypes.CDLL(str(library_path()))
        lib.feeder_parse_workload.restype = ctypes.c_void_p
        lib.feeder_parse_workload.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.feeder_parse_machines.restype = ctypes.c_void_p
        lib.feeder_parse_machines.argtypes = [ctypes.c_char_p]
        lib.feeder_error.restype = ctypes.c_char_p
        lib.feeder_error.argtypes = [ctypes.c_void_p]
        lib.feeder_workload_count.restype = ctypes.c_int64
        lib.feeder_workload_count.argtypes = [ctypes.c_void_p]
        lib.feeder_machine_count.restype = ctypes.c_int64
        lib.feeder_machine_count.argtypes = [ctypes.c_void_p]
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.feeder_workload_fill.restype = None
        lib.feeder_workload_fill.argtypes = [ctypes.c_void_p, f64p, i64p, i64p, f64p, i64p, i64p, i64p]
        lib.feeder_workload_fill_range.restype = None
        lib.feeder_workload_fill_range.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, f64p, i64p, i64p, f64p, i64p, i64p, i64p,
        ]
        lib.feeder_machine_fill.restype = None
        lib.feeder_machine_fill.argtypes = [ctypes.c_void_p, f64p, i32p, i64p, i64p, i64p]
        lib.feeder_free.restype = None
        lib.feeder_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def native_build_error() -> Optional[str]:
    _load()
    return _build_error


@dataclass
class WorkloadArrays:
    """Dense pod-creation events, stably sorted by start timestamp."""

    start_ts: np.ndarray  # (P,) float64 seconds
    cpu_millicores: np.ndarray  # (P,) int64
    ram_bytes: np.ndarray  # (P,) int64
    duration: np.ndarray  # (P,) float64 seconds
    job_id: np.ndarray  # (P,) int64; -1 encodes a missing job id
    task_id: np.ndarray  # (P,) int64
    pod_no: np.ndarray  # (P,) int64 per-trace running pod counter

    def pod_name(self, i: int) -> str:
        # The Python path's f"{job_id}_{task_id}_{n}", where a missing job
        # id renders as the literal "None".
        jid = "None" if self.job_id[i] == -1 else str(int(self.job_id[i]))
        return f"{jid}_{int(self.task_id[i])}_{int(self.pod_no[i])}"


@dataclass
class ClusterArrays:
    """Dense node lifecycle events (kind 0 = create, 1 = remove), sorted."""

    ts: np.ndarray  # (M,) float64 seconds
    kind: np.ndarray  # (M,) int32
    cpu_millicores: np.ndarray  # (M,) int64 (creates only)
    ram_bytes: np.ndarray  # (M,) int64 (creates only)
    machine_id: np.ndarray  # (M,) int64

    def node_name(self, i: int) -> str:
        return f"alibaba_node_{int(self.machine_id[i])}"


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native feeder unavailable: {_build_error}")
    return lib


def _take_handle(lib: ctypes.CDLL, handle: int) -> int:
    if not handle:
        raise RuntimeError("native feeder returned a null handle")
    err = lib.feeder_error(ctypes.c_void_p(handle)).decode()
    if err:
        lib.feeder_free(ctypes.c_void_p(handle))
        raise ValueError(err)
    return handle


def _empty_workload(n: int) -> WorkloadArrays:
    return WorkloadArrays(
        start_ts=np.empty(n, np.float64),
        cpu_millicores=np.empty(n, np.int64),
        ram_bytes=np.empty(n, np.int64),
        duration=np.empty(n, np.float64),
        job_id=np.empty(n, np.int64),
        task_id=np.empty(n, np.int64),
        pod_no=np.empty(n, np.int64),
    )


def load_workload_arrays(batch_instance_path: str, batch_task_path: str) -> WorkloadArrays:
    """Parse, join and filter the workload CSVs natively."""
    lib = _require()
    handle = _take_handle(lib, lib.feeder_parse_workload(batch_instance_path.encode(), batch_task_path.encode()))
    try:
        n = lib.feeder_workload_count(ctypes.c_void_p(handle))
        out = _empty_workload(n)
        if n:
            lib.feeder_workload_fill(
                ctypes.c_void_p(handle), out.start_ts, out.cpu_millicores, out.ram_bytes,
                out.duration, out.job_id, out.task_id, out.pod_no,
            )
        return out
    finally:
        lib.feeder_free(ctypes.c_void_p(handle))


class WorkloadSegmentReader:
    """Keep-alive handle over the natively parsed workload: rows [lo, lo +
    n) of the one stable time sort come back as bounded WorkloadArrays
    segments, so the Python working set is one segment (the trace half of
    the streaming feeder: trace_compile.FeederPayloadSource reads it).
    Concatenating every segment reproduces load_workload_arrays.

        with WorkloadSegmentReader(bi_path, bt_path) as r:
            for lo, seg in r.iter_segments(rows_per_segment=1_000_000):
                ...
    """

    def __init__(self, batch_instance_path: str, batch_task_path: str):
        lib = _require()
        self._lib = lib
        self._handle: Optional[int] = _take_handle(
            lib, lib.feeder_parse_workload(batch_instance_path.encode(), batch_task_path.encode())
        )
        self._count = int(lib.feeder_workload_count(ctypes.c_void_p(self._handle)))

    def __len__(self) -> int:
        return self._count

    def read(self, lo: int, n: int) -> WorkloadArrays:
        """Rows [lo, lo + n) of the sorted workload (clamped to the end)."""
        if self._handle is None:
            raise ValueError("WorkloadSegmentReader is closed")
        if lo < 0:
            raise ValueError(f"segment lo must be >= 0, got {lo}")
        n = max(0, min(n, self._count - lo))
        out = _empty_workload(n)
        if n:
            self._lib.feeder_workload_fill_range(
                ctypes.c_void_p(self._handle), lo, n, out.start_ts, out.cpu_millicores, out.ram_bytes,
                out.duration, out.job_id, out.task_id, out.pod_no,
            )
        return out

    def iter_segments(self, rows_per_segment: int):
        """(lo, WorkloadArrays) over the whole workload, in order."""
        if rows_per_segment <= 0:
            raise ValueError("rows_per_segment must be positive")
        for lo in range(0, self._count, rows_per_segment):
            yield lo, self.read(lo, rows_per_segment)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.feeder_free(ctypes.c_void_p(self._handle))
            self._handle = None

    def __enter__(self) -> "WorkloadSegmentReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


def _rows(a: WorkloadArrays, lo: int, hi: int) -> WorkloadArrays:
    return WorkloadArrays(
        start_ts=a.start_ts[lo:hi],
        cpu_millicores=a.cpu_millicores[lo:hi],
        ram_bytes=a.ram_bytes[lo:hi],
        duration=a.duration[lo:hi],
        job_id=a.job_id[lo:hi],
        task_id=a.task_id[lo:hi],
        pod_no=a.pod_no[lo:hi],
    )


class WorkloadArraysReader:
    """The same (lo, n) -> WorkloadArrays contract as
    WorkloadSegmentReader.read over materialized WorkloadArrays (views, no
    copies), for callers without the native toolchain."""

    def __init__(self, arrays: WorkloadArrays) -> None:
        self.arrays = arrays
        self._count = len(arrays.start_ts)

    def __len__(self) -> int:
        return self._count

    def read(self, lo: int, n: int) -> WorkloadArrays:
        if lo < 0:
            raise ValueError(f"segment lo must be >= 0, got {lo}")
        return _rows(self.arrays, lo, min(lo + max(n, 0), self._count))


def iter_workload_segments(arrays: WorkloadArrays, rows_per_segment: int):
    """WorkloadSegmentReader.iter_segments over materialized arrays."""
    if rows_per_segment <= 0:
        raise ValueError("rows_per_segment must be positive")
    total = len(arrays.start_ts)
    for lo in range(0, total, rows_per_segment):
        yield lo, _rows(arrays, lo, min(lo + rows_per_segment, total))


def load_cluster_arrays(machine_events_path: str) -> ClusterArrays:
    """Parse and deduplicate the machine-events CSV natively."""
    lib = _require()
    handle = _take_handle(lib, lib.feeder_parse_machines(machine_events_path.encode()))
    try:
        n = lib.feeder_machine_count(ctypes.c_void_p(handle))
        out = ClusterArrays(
            ts=np.empty(n, np.float64),
            kind=np.empty(n, np.int32),
            cpu_millicores=np.empty(n, np.int64),
            ram_bytes=np.empty(n, np.int64),
            machine_id=np.empty(n, np.int64),
        )
        if n:
            lib.feeder_machine_fill(
                ctypes.c_void_p(handle), out.ts, out.kind, out.cpu_millicores, out.ram_bytes, out.machine_id,
            )
        return out
    finally:
        lib.feeder_free(ctypes.c_void_p(handle))


def workload_events_from_arrays(arrays: WorkloadArrays) -> List[Tuple[float, object]]:
    """The dense arrays as CreatePodRequest trace events (the object form
    of compile_cluster_trace)."""
    from kubernetriks_tpu_torch.core.events import CreatePodRequest
    from kubernetriks_tpu_torch.core.types import Pod

    return [
        (
            float(arrays.start_ts[i]),
            CreatePodRequest(pod=Pod.new(
                arrays.pod_name(i), int(arrays.cpu_millicores[i]), int(arrays.ram_bytes[i]),
                float(arrays.duration[i]),
            )),
        )
        for i in range(len(arrays.start_ts))
    ]


def cluster_events_from_arrays(arrays: ClusterArrays) -> List[Tuple[float, object]]:
    from kubernetriks_tpu_torch.core.events import CreateNodeRequest, RemoveNodeRequest
    from kubernetriks_tpu_torch.core.types import Node

    events = []
    for i in range(len(arrays.ts)):
        name = arrays.node_name(i)
        if int(arrays.kind[i]) == 0:
            node = Node.new(name, int(arrays.cpu_millicores[i]), int(arrays.ram_bytes[i]))
            events.append((float(arrays.ts[i]), CreateNodeRequest(node=node)))
        else:
            events.append((float(arrays.ts[i]), RemoveNodeRequest(node_name=name)))
    return events


def iter_time_slabs(arrays: WorkloadArrays, slab_seconds: float) -> List[Tuple[float, float, slice]]:
    """The sorted workload cut into [t0, t0 + slab) windows: (slab start,
    slab end, row slice) triples."""
    if len(arrays.start_ts) == 0:
        return []
    t_end = float(arrays.start_ts[-1])
    slabs = []
    lo = 0
    slab_start = float(arrays.start_ts[0])
    while slab_start <= t_end:
        slab_end = slab_start + slab_seconds
        hi = int(np.searchsorted(arrays.start_ts, slab_end, side="left"))
        if hi > lo:
            slabs.append((slab_start, slab_end, slice(lo, hi)))
        lo = hi
        slab_start = slab_end
    return slabs


class NativeAlibabaWorkloadTrace:
    """Trace interface over the native workload arrays: in place of
    trace.alibaba.AlibabaWorkloadTraceV2017 where the feeder builds."""

    def __init__(self, arrays: WorkloadArrays) -> None:
        self.arrays: Optional[WorkloadArrays] = arrays

    @staticmethod
    def from_files(batch_instance_trace_path: str, batch_task_trace_path: str) -> "NativeAlibabaWorkloadTrace":
        return NativeAlibabaWorkloadTrace(load_workload_arrays(batch_instance_trace_path, batch_task_trace_path))

    def convert_to_simulator_events(self):
        arrays, self.arrays = self.arrays, None
        return [] if arrays is None else workload_events_from_arrays(arrays)

    def event_count(self) -> int:
        return 0 if self.arrays is None else len(self.arrays.start_ts)


class NativeAlibabaClusterTrace:
    """Trace interface over the native machine-event arrays."""

    def __init__(self, arrays: ClusterArrays) -> None:
        self.arrays: Optional[ClusterArrays] = arrays

    @staticmethod
    def from_file(machine_events_trace_path: str) -> "NativeAlibabaClusterTrace":
        return NativeAlibabaClusterTrace(load_cluster_arrays(machine_events_trace_path))

    def convert_to_simulator_events(self):
        arrays, self.arrays = self.arrays, None
        return [] if arrays is None else cluster_events_from_arrays(arrays)

    def event_count(self) -> int:
        return 0 if self.arrays is None else len(self.arrays.ts)
