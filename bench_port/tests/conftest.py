"""Fixtures of the benchmark's CPU tests.

``tiny_root`` is a checkout-shaped directory whose ``BENCHMARK.json`` keeps
the real cells' names, metrics and traffic kinds but points each cell at a
configuration and a traffic file small enough for the CPU: a 128 x 128
moon terrain, a 600 mm root box down to 40 mm cells with three
orientations, a pool of two terrains.  The metric readers are the real
ones.  Nothing here needs a card.
"""

import json
import os
import sys

import pytest
import torch

# the tests run the port's plain paths on the CPU: a few threads a process,
# so that several test workers do not oversubscribe the host
torch.set_num_threads(min(4, os.cpu_count() or 1))

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

BENCH = os.path.join(REPO, "bench_port")


def _load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def tiny_solve_config(name="quad-tiny"):
    q = _load(BENCH, "configs", "quad-m2-moon64k.json")
    q["name"] = name
    q["terrain"]["shape"] = [128, 128]
    q["solver"].update(box_half=[600.0] * 3, min_box=[40.0] * 3,
                       angle_samples=[3, 1, 1], enable_rot_below=100.0)
    return q


def tiny_traffic(name):
    d = _load(BENCH, "traffic", name + ".json")
    d["pool"] = 2
    d["check"].update(cells_per_level=16, deepest_cells=32)
    return d


def make_root(path, extra=None):
    """A checkout-shaped directory at ``path`` with the tiny cells, and the
    entries and files of ``extra`` (``configs``, ``traffic``,
    ``workloads`` lists of dicts) added."""
    for d in ("configs", "traffic"):
        os.makedirs(os.path.join(path, "bench_port", d), exist_ok=True)
    os.symlink(os.path.join(BENCH, "metrics"),
               os.path.join(path, "bench_port", "metrics"))
    m = _load(REPO, "BENCHMARK.json")
    cfgs = {"quad-tiny": tiny_solve_config()}
    traffic = {t + "-tiny": tiny_traffic(t)
               for t in ("solve-shared", "solve-perleg")}
    wl = {"quad-m2.solve-shared": ("quad-tiny", "solve-shared-tiny"),
          "quad-m2.solve-perleg": ("quad-tiny", "solve-perleg-tiny")}
    extra = extra or {}
    for c in extra.get("configs", []):
        cfgs[c["name"]] = c
    for t in extra.get("traffic", []):
        traffic[t.pop("name")] = t
    for name, c in cfgs.items():
        with open(os.path.join(path, "bench_port", "configs",
                               name + ".json"), "w") as f:
            json.dump(c, f)
    for name, t in traffic.items():
        with open(os.path.join(path, "bench_port", "traffic",
                               name + ".json"), "w") as f:
            json.dump(t, f)
    m["configs"] = [dict(name=n, source="https://example.org/tiny",
                         file=f"bench_port/configs/{n}.json", reduced=[],
                         why="a CPU-sized stand-in") for n in cfgs]
    for w in m["workloads"]:
        w["config"], w["traffic"] = wl[w["name"]]
    m["workloads"] += extra.get("workloads", [])
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    return str(path)


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
