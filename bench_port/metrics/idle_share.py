"""``idle_share.<end-to-end metric's cells>``: the share of the traced
window, in percent, in which no kernel, copy or fill ran on the device (1 -
the union of the device's activity intervals over the window, from the
profiler)."""

from bench_port.trace import busy_and_gaps


def read(view):
    t = view.trace
    if t is None or t.window_s <= 0:
        return None
    busy, _ = busy_and_gaps(t.device, t.window)
    return 100.0 * (1.0 - busy * 1e-9 / t.window_s)
