"""Operations of the profiled label training steps (`training.train_step`),
counted from the shapes of the published RandLA-Net by work/segmentation.py,
per second of their stretch on the device, over the card's fp32-grade peak
(peaks.FP32_GRADE_FLOPS): no implementation at fp32 grade reads above 100%."""
from benchmark import peaks
from benchmark.work import segmentation


def read(r):
    if not r.pairs or r.window_s <= 0:
        return None
    flops = segmentation.per_pair(r.model, r.traffic) * r.pairs
    return 100.0 * flops / r.window_s / peaks.FP32_GRADE_FLOPS
