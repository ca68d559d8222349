"""Keeps the CPU tests' tiny checkouts to the cells they have stand-ins for.

``tests/conftest.py``'s ``make_root`` gives each cell of the repo's
``BENCHMARK.json`` a CPU-sized configuration and traffic file by the
cell's name, and knows the solve cells only.  A cell added since brings
its stand-in itself, through ``make_root``'s ``extra`` (as
``tests/test_benchport_map.py`` does), so every test here sees the
repo's manifest without the cells that ``make_root`` has no stand-in for.
"""

import sys

import pytest

#: the cells ``tests/conftest.py`` maps to a stand-in
STAND_INS = ("quad-m2.solve-shared", "quad-m2.solve-perleg")


@pytest.fixture(autouse=True)
def _cells_with_stand_ins(monkeypatch):
    tiny = sys.modules.get("conftest")
    if tiny is None or not hasattr(tiny, "make_root"):
        return
    load = tiny._load

    def _load(*parts):
        d = load(*parts)
        if parts[-1] == "BENCHMARK.json":
            d["workloads"] = [w for w in d["workloads"]
                              if w["name"] in STAND_INS]
        return d

    monkeypatch.setattr(tiny, "_load", _load)
