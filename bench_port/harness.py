"""Run one cell of ``BENCHMARK.json`` once and produce its result line.

A cell names a configuration and a traffic mix; the traffic file's
``kind`` names the runner in ``kinds/``, and every metric is read by the
reader ``metrics/<name>.py``.  The run:

1. set-up: the runner makes the cell's inputs from the seed on the device,
   builds what the program needs and sends one request, so that every
   shape the window uses is warm (``setup_s`` ends here);
2. the window: a closed loop with one client sends requests until
   ``seconds`` have passed and takes the last one in flight to its end;
   with ``trace`` the first ``traced_requests`` of them run under
   ``torch.profiler``;
3. the device's memory peak is read, the program's state is dropped, and
   the plain reference judges a seeded sample of what the window produced:
   every number compared, with its limit, decides ``correct``;
4. the metrics of the cell are read: the end-to-end metrics without
   ``trace``, the per-layer metrics with it.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from typing import NamedTuple

import torch

from bench_port import trace as tr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "legmov_tpu")


class Request(NamedTuple):
    index: int
    start: float  # host clock, s
    end: float
    ok: bool


class RunView(NamedTuple):
    """What a metric reader sees."""

    kind: str
    setup_s: float
    window: tuple  # (start, end) host clock, s
    requests: list  # [Request] of the window
    per_request: list  # the runner's per-request records (program stats)
    traced: list  # indices of the traced requests
    trace: object  # tr.TraceData, or None without --trace
    counts: dict  # name -> (operations, bytes) per request

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_files(manifest: dict, workload: str, root: str = ROOT):
    """``(cell, config, traffic)`` of ``workload``, each a dict."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{sorted(cells)}")
    cell = cells[workload]
    cfgs = {c["name"]: c for c in manifest["configs"]}
    with open(os.path.join(root, cfgs[cell["config"]]["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "bench_port", "traffic",
                           cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    if (traffic["loop"], traffic["clients"]) != ("closed", 1):
        raise ValueError(f"traffic {cell['traffic']!r}: the harness drives "
                         "one client in a closed loop only")
    return cell, cfg, traffic


def judge(checks: dict, limits: dict, failed: int) -> bool:
    """``correct``: no request failed and every number compared is within
    its limit (a number that could not be read fails)."""
    return failed == 0 and all(
        checks[k] is not None and checks[k] <= limits[k] for k in limits)


def metrics_of(manifest: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of ``workload`` reports."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def reader(name: str, root: str = ROOT):
    """The ``read(view)`` function of ``metrics/<name>.py``, or, where no
    file has the whole name, of ``metrics/<name up to its first '.'>.py``:
    one reader serves a quantity that the manifest splits by the end-to-end
    metric it moves (``idle_share.shared``, ``idle_share.per_leg``)."""
    base = os.path.join(root, "bench_port", "metrics")
    path = os.path.join(base, name + ".py")
    if not os.path.exists(path):
        path = os.path.join(base, name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_port.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out[0].split(",")[-1].strip() if out else "unknown"


class Spans:
    """The benchmark's spans: ``torch.profiler.record_function`` while a
    trace records, nothing otherwise."""

    def __init__(self):
        self.on = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.on:
            with torch.profiler.record_function(tr.SPAN_PREFIX + name):
                yield
        else:
            yield


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", root: str = ROOT, t_start: float | None = None,
        manifest: dict | None = None, log=sys.stderr, control=None) -> dict:
    """Run ``workload`` once; returns the result line as a dict (its last
    key, ``checks``, holds every number compared beside its limit).
    ``control`` (a function that rounds the reference's inputs) judges the
    control in the program's place instead of the program's outputs."""
    t_start = time.perf_counter() if t_start is None else t_start
    manifest = load_manifest(root) if manifest is None else manifest
    cell, cfg, traffic = cell_files(manifest, workload, root)
    dev = torch.device(device)
    kind = importlib.import_module("bench_port.kinds." + traffic["kind"])
    spans = Spans()
    runner = kind.CellRunner(cfg, traffic, seed, dev, spans)
    runner.setup()
    runner.request(-1, keep=False)  # warm every shape of the window
    _sync(dev)
    setup_s = time.perf_counter() - t_start

    n_traced = int(traffic.get("traced_requests", 1)) if trace else 0
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    if n_traced:
        # the profiler's first start initialises its tracing for seconds:
        # done here, it stays out of the window
        with torch.profiler.profile(activities=acts):
            torch.ones(1, device=dev).sum()
            _sync(dev)
    requests, prof = [], None

    def stop_trace():
        _sync(dev)
        prof.__exit__(None, None, None)
        spans.on = False

    w0 = time.perf_counter()
    deadline = w0 + seconds
    i = 0
    while True:
        if i == 0 and n_traced:
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            spans.on = True
        t0 = time.perf_counter()
        ok = True
        try:
            with spans("request"):
                runner.request(i)
        except Exception:  # a failed request is counted, and the run goes on
            traceback.print_exc(file=log)
            ok = False
        t1 = time.perf_counter()
        requests.append(Request(i, t0, t1, ok))
        i += 1
        if spans.on and i == n_traced:
            stop_trace()
        if t1 >= deadline:
            break
    if spans.on:  # the window closed before the traced requests ran out
        stop_trace()
    window = (w0, requests[-1].end)
    traced = [r.index for r in requests[:n_traced] if r.ok]

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    runner.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    done = [r.index for r in requests if r.ok]
    limits = traffic["check"]["limits"]
    if done:
        checks, counts, notes = runner.check(done, traced, want_counts=trace,
                                             control=control)
    else:  # nothing to judge: no number can pass
        checks, counts, notes = {k: None for k in limits}, {}, {}
    failed = sum(not r.ok for r in requests)
    correct = judge(checks, limits, failed)

    trace_data = tr.read_profile(prof) if prof is not None else None
    view = RunView(traffic["kind"], setup_s, window, requests,
                   runner.per_request, traced, trace_data, counts)
    metrics = {}
    for m in metrics_of(manifest, workload, trace):
        value = reader(m["name"], root)(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(peak),
        "power_limit": power_limit() if dev.type == "cuda" else "none",
    }
    result = {"correct": bool(correct), "attempted": len(requests),
              "failed": failed, "metrics": metrics, "device": device_info}
    if trace_data is not None:
        busy, gaps = tr.busy_and_gaps(trace_data.device, trace_data.window)
        device_info["busy_s"] = busy * 1e-9
        device_info["window_s"] = trace_data.window_s
        result["breakdown"] = {
            "device_ops": tr.top_device_ops(trace_data.device),
            "idle_gaps": tr.idle_gaps(trace_data, gaps)}
        for name, n in _launches(runner, traced).items():
            seen = sum(name in k.name for k in trace_data.kernels)
            print(f"trace: {name}: {n} launches counted, {seen} traced",
                  file=log)
    result["samples"] = {"requests": len(done), **notes}
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in limits}
    return result


def _launches(runner, traced: list) -> dict:
    tot: dict = {}
    for rec in runner.per_request:
        if rec["index"] in traced:
            for k, v in rec["launches"].items():
                tot[k] = tot.get(k, 0) + v
    return tot


def emit(result: dict, out=sys.stdout, log=sys.stderr) -> None:
    """Print the result: each number compared beside its limit as the last
    lines on standard error, and the JSON line as the last line on
    standard output."""
    out.flush()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=log)
    log.flush()
    print(json.dumps(result), file=out)
    out.flush()
