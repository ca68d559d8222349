"""``k6b_ms``: device milliseconds a solve in K6b, the deepest level under
the shared rule (ops/csr_cell_eval.py): the profiler's kernel time of
``legmov_cell_shared_kernel`` over the traced solves."""

from bench_port.trace import kernel_seconds


def read(view):
    t = view.trace
    if t is None or view.kind != "solve" or not view.traced:
        return None
    s = kernel_seconds(t.kernels, "legmov_cell_shared_kernel")
    return s * 1e3 / len(view.traced) if s > 0 else None
