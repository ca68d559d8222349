"""``host_idle_s.<rule>``: seconds a solve in which the device idles while
the program's host loop works outside the levels' fetches: the device's
idle time (the profiler's device events) inside the program's
``legmov.solve`` spans and outside their ``legmov.level.fetch`` spans,
summed over the traced solves, over their count."""

from bench_port.spans import solve_idle


def read(view):
    idle = solve_idle(view)
    return None if idle is None else idle[1] * 1e-9 / len(view.traced)
