"""``k2_cells_ms.<rule>``: device milliseconds a solve in K2's cell driver on
the identity levels (ops/cuda_kernels.py ``distance_cells_kernel``): the
profiler's kernel time of ``legmov_dist_cells_kernel`` over the traced
solves."""

from bench_port.trace import kernel_seconds


def read(view):
    t = view.trace
    if t is None or view.kind != "solve" or not view.traced:
        return None
    s = kernel_seconds(t.kernels, "legmov_dist_cells_kernel")
    return s * 1e3 / len(view.traced) if s > 0 else None
