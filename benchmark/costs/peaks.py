"""Published peaks of one NVIDIA H100 SXM at its full 700 W (NVIDIA's data
sheet, dense rates): fp32 on the CUDA cores outside the tensor cores, and
HBM3 bandwidth. The configurations compute in IEEE fp32 (TF32 off), so the
fp32 rate is the ceiling of every product they run."""

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take for this work: the larger of
    its operations over the fp32 peak and its bytes over the bandwidth."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)
