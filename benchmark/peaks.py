"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W), frozen: the yardstick of every roofline and MFU share."""

FP32_FLOPS = 67e12                   # CUDA cores
TF32_FLOPS = 495e12                  # tensor cores
BF16_FLOPS = 989e12                  # tensor cores
HBM_BYTES = 3.35e12                  # bytes per second
# the fastest rate at fp32 grade: three TF32 products per fp32 product
FP32_GRADE_FLOPS = TF32_FLOPS / 3


def bound_s(flops: float, nbytes: float, peak: float) -> float:
    """The least time the card could take: operations or bytes, the larger."""
    return max(flops / peak, nbytes / HBM_BYTES)
