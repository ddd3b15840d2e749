"""Model operations of the profiled batches (`training.device_batch` and
`Network.forward_align`), counted from the shapes by work/model.py, per
second of their stretch on the device, over the card's fp32-grade peak
(peaks.FP32_GRADE_FLOPS): no implementation at fp32 grade reads above 100%."""
from benchmark.profiling import mfu_pct as read  # noqa: F401
