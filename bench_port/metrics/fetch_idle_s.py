"""``fetch_idle_s.<rule>``: seconds a solve in which the device idles while
the program packs a level's flags and reads them back: the device's idle
time (the profiler's device events) inside the program's
``legmov.level.fetch`` spans, summed over the traced solves, over their
count."""

from bench_port.spans import solve_idle


def read(view):
    idle = solve_idle(view)
    return None if idle is None else idle[0] * 1e-9 / len(view.traced)
