"""The pyramid's KNN searches in the profiled label training steps as a share
of their roofline: the least time the card could take for every search both
clouds' pyramids need (work/knn.py, from the shapes) over the device time of
the kernels that ran them under the program's span `deepsir.pyramid`.
Kernels read: K1 and K4's shared core."""
from benchmark.profiling import named
from benchmark.program_spans import events
from benchmark.work import knn

KERNELS = ("knn_select::knn_kernel",)


def read(r):
    mine = named(events(r, "deepsir.pyramid"), KERNELS)
    if not mine or not r.units:
        return None
    m, b = r.model, r.traffic["batch"]
    bound = sum(knn.bound_s(*s) for s in knn.pyramid_searches(
        r.traffic["points"], m["num_knn"], m["sub_sampling_ratio"], b)) * 2 * r.units
    return 100.0 * bound / (sum(e.dur for e in mine) * 1e-6)
