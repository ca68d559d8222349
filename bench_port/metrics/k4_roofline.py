"""``k4_roofline``: K4's share of its roofline, in percent: the least time
the card could take for what a request needs (``counts/k4.py``: the larger
of the operations over the float32 peak and the bytes over the bandwidth,
bench_port/peaks.py) over the kernel's traced time a request."""

from bench_port.peaks import roofline_pct
from bench_port.trace import kernel_seconds

KERNEL = "legmov_csr_round_kernel"


def read(view):
    t = view.trace
    if t is None or "map_request" not in view.counts or not view.traced:
        return None
    s = kernel_seconds(t.kernels, KERNEL) / len(view.traced)
    if s <= 0:
        return None
    ops, n_bytes = view.counts["map_request"]
    return roofline_pct(ops, n_bytes, s)
