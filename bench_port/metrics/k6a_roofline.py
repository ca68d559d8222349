"""``k6a_roofline``: K6a's share of its roofline, in percent: the least time
the card could take for what the inputs need (``counts/k6.py``: the larger
of the operations over the float32 peak and the bytes over the bandwidth,
bench_port/peaks.py) over the kernel's traced time a request."""

from bench_port.peaks import roofline_pct
from bench_port.trace import kernel_seconds


def read(view):
    t = view.trace
    if t is None or "deepest_level" not in view.counts or not view.traced:
        return None
    s = kernel_seconds(
        t.kernels, "legmov_cell_quat_major_kernel") / len(view.traced)
    if s <= 0:
        return None
    ops, n_bytes = view.counts["deepest_level"]
    return roofline_pct(ops, n_bytes, s)
