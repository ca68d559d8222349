"""Published peaks of the card, and the roofline share they give.

NVIDIA's H100 SXM data sheet, dense rates at the 700 W power limit: 67
TFLOP/s in float32 outside the tensor cores and 3.35 TB/s of HBM3.  The
program's kernels compute in float32 on the CUDA cores, so those are the
two roofs; a run reports the card's power limit beside them.
"""

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def roofline_pct(ops: float, n_bytes: float, seconds: float):
    """The least time the card could take (the larger of the operations
    over the float32 peak and the bytes over the bandwidth) as a share of
    ``seconds``, in percent; ``None`` without a time to divide by."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * max(ops / FP32_FLOPS, n_bytes / HBM_BYTES_PER_S) / seconds

