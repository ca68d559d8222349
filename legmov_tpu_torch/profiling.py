"""Profiling and timing utilities.

The reference brackets kernels with cudaEvents and appends per-stage
timings to ``timing_results.txt`` (HeaderCUDA.h:161-198 ``CUDA_TIMING_*``,
cross_compiled.cu:54-65).  Here: a ``torch.profiler`` trace context for deep
dives, a stage timer with the same append-to-file habit, the kernels' launch
counters, CUDA events around every call of the kernels' C launchers, and
the label of the device a measurement ran on (the card's name and power
limit, or the host CPU's model).  The program's own spans and phase clocks
(:class:`phase`) live in the leaf module ``spans``, which the solver and the
kernels' wrappers import.
"""

from __future__ import annotations

import contextlib
import os
import platform
import subprocess
import time

import torch

from legmov_tpu_torch.ops import csr_cell_eval as cce
from legmov_tpu_torch.ops import cuda_kernels as ck
from legmov_tpu_torch.ops import cuda_multileg as cm
from legmov_tpu_torch.ops import cuda_multileg_dist as cmd
from legmov_tpu_torch.spans import phase  # noqa: F401  (re-exported)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block, CPU activity and, on a card, CUDA
    activity; the Chrome trace is written to ``log_dir/trace.json`` on exit.
    Yields the profiler (``key_averages()`` for sums by kernel)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Named stage wall-clock timer, optionally appending to a file.

    The functional twin of the reference's ``CUDA_TIMING_START/STOP`` pair
    writing ``timing_results.txt`` (HeaderCUDA.h:161-198).  When ``sync`` is
    a CUDA tensor, the clock is read once the work queued on its stream has
    run (an event on that stream, then a wait for it).
    """

    def __init__(self, path: str | None = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self.records: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if isinstance(sync, torch.Tensor) and sync.is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(sync.device))
            done.synchronize()
        dt = time.perf_counter() - t0
        self.records.append((name, dt))
        line = f"{name}: {dt * 1e3:.3f} ms"
        if self.echo:
            print(line)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")


#: kernel -> the wrapper whose ``launches`` counts its launches
COUNTERS = {
    "reachability": (ck, "reachability_kernel"),
    "distance": (ck, "distance_kernel"),
    "distance_cells": (ck, "distance_cells_kernel"),
    "io_only": (ck, "io_only_kernel"),
    "multileg": (cm, "multileg_kernel"),
    "csr_window": (cm, "csr_window_kernel"),
    "csr_round": (cm, "csr_round_kernel"),
    "item": (cmd, "multileg_distance_kernel"),
    "item_cells": (cmd, "item_cells_kernel"),
    "cell_quat_major": (cce, "cell_eval_quat_major"),
    "cell_shared": (cce, "cell_eval_shared"),
    "cell_cm_perleg": (cce, "cell_eval_cm_perleg"),
}

#: kernel -> (its library, its C launcher)
LAUNCHERS = {
    "reachability": (ck._library, "legmov_reachability"),
    "distance": (ck._library, "legmov_distance"),
    "distance_cells": (ck._library, "legmov_distance_cells"),
    "multileg": (cm._library, "legmov_multileg"),
    "csr_window": (cm._library, "legmov_csr_window"),
    "csr_round": (cm._library, "legmov_csr_round"),
    "item": (cmd.library, "legmov_item"),
    "item_cells": (cmd.library, "legmov_item_cells"),
    "cell_quat_major": (cmd.library, "legmov_cell_quat_major"),
    "cell_shared": (cmd.library, "legmov_cell_shared"),
    "cell_cm_perleg": (cmd.library, "legmov_cell_cm_perleg"),
}


def launch_counts() -> dict:
    """Every kernel wrapper's launch count."""
    return {name: getattr(mod, attr).launches
            for name, (mod, attr) in COUNTERS.items()}


@contextlib.contextmanager
def kernel_clock(kernels=tuple(LAUNCHERS)):
    """Record a pair of CUDA events around every call of the C launchers of
    ``kernels`` inside the block: the events enclose the kernel's enqueue
    and nothing of the wrapper's host work, so on a host-bound path the
    interval is the kernel's own time and not the host's.  Yields kernel ->
    list of (start, end, launcher arguments); read them after the path's
    last synchronisation (:func:`clock_sums`).  Builds the libraries."""
    recs = {key: [] for key in kernels}
    saved = []
    for key in kernels:
        get_lib, fname = LAUNCHERS[key]
        lib = get_lib()
        real = getattr(lib, fname)

        def timed(*args, _real=real, _rec=recs[key]):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            err = _real(*args)
            e1.record()
            _rec.append((e0, e1, args))
            return err

        setattr(lib, fname, timed)
        saved.append((lib, fname, real))
    try:
        yield recs
    finally:
        for lib, fname, real in saved:
            setattr(lib, fname, real)


def clock_sums(recs) -> dict:
    """kernel -> {"launches", "ms"} of a :func:`kernel_clock` record (after a
    synchronisation), for the kernels launched."""
    torch.cuda.synchronize()
    return {key: {"launches": len(rec),
                  "ms": sum(a.elapsed_time(b) for a, b, _ in rec)}
            for key, rec in recs.items() if rec}


def device_label(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or the
    host CPU's model and PyTorch's thread count."""
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout
        return smi.strip().splitlines()[0]
    return f"cpu: {cpu_model()}, {torch.get_num_threads()} threads"


def cpu_model() -> str:
    """The host CPU's model name: /proc/cpuinfo's ``model name``, else
    ``lscpu``'s ``Model name``, else (where a virtual machine reports
    neither) the vendor, family and model numbers of /proc/cpuinfo."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    names = [fields.get("model name", "")]
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=10).stdout
        names += [line.split(":", 1)[1].strip() for line in out.splitlines()
                  if line.startswith("Model name")]
    except (OSError, subprocess.TimeoutExpired):
        pass
    for name in names:
        if name and name.lower() != "unknown":
            return name
    ids = " ".join(f"{k} {fields[k]}" for k in ("cpu family", "model")
                   if k in fields)
    return (f"{fields.get('vendor_id', platform.machine())} {ids} (model "
            f"name not reported), {os.cpu_count()} cores").replace("  ", " ")
