"""Program spans: a phase clock that always runs, and a profiler range that
is opened only while a profiler records.

``with phase("level.split", into=seconds):`` reads the host clock at both
ends and adds the interval to ``seconds["level.split"]``.  While
``torch.profiler`` records, the block is also a range named
``legmov.level.split`` on the profiler's clock, so a trace can cut each idle
gap of the device by the program step the host was in.  The range is a
host-only one (``_RecordFunctionFast``, not a user annotation): the profiler
does not mirror it onto the device's timeline, where it would read as
device activity.  With no profiler the range costs one flag check.

A leaf module: the solver and the kernels' wrappers import it, and
``profiling`` re-exports :class:`phase`.
"""

from __future__ import annotations

import time

import torch

#: prefix of every program span's name in a trace
PREFIX = "legmov."


class phase:
    """Context manager: the block's host seconds into ``into[name]`` (added
    to what is there), and a ``legmov.<name>`` profiler range while a
    profiler records.  ``seconds`` holds the block's interval once it has
    ended."""

    __slots__ = ("name", "into", "seconds", "_t0", "_range")

    def __init__(self, name: str, into: dict | None = None):
        self.name = name
        self.into = into
        self.seconds = 0.0

    def __enter__(self):
        self._range = None
        # the flag first: an idle profiler range costs tens of times more
        if torch.autograd._profiler_enabled():
            self._range = torch._C._profiler._RecordFunctionFast(
                PREFIX + self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        if self.into is not None:
            self.into[self.name] = self.into.get(self.name, 0.0) + self.seconds
        return False
