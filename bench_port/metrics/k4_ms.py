"""``k4_ms``: device milliseconds a map request in K4, the csr-dma round
kernel (ops/cuda_multileg.py ``csr_round_kernel``): the profiler's kernel
time of ``legmov_csr_round_kernel`` over the traced requests."""

from bench_port.trace import kernel_seconds

KERNEL = "legmov_csr_round_kernel"


def read(view):
    t = view.trace
    if t is None or view.kind != "map" or not view.traced:
        return None
    s = kernel_seconds(t.kernels, KERNEL)
    return s * 1e3 / len(view.traced) if s > 0 else None
