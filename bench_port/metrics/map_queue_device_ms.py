"""``map_queue_device_ms``: device milliseconds a map request in every
kernel other than K4: the csr-dma solver's eager work around the round
kernel (ops/csr_grid.py ``make_csr_dma_solver``: the column relevance, the
oriented tables, the schedule's compaction), the profiler's kernel time
over the traced requests."""

KERNEL = "legmov_csr_round_kernel"


def read(view):
    t = view.trace
    if t is None or view.kind != "map" or not view.traced:
        return None
    ns = sum(k.end - k.start for k in t.kernels if KERNEL not in k.name)
    return ns * 1e-6 / len(view.traced) if ns > 0 else None
