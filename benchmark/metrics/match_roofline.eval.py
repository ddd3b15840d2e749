"""The registration loop's descriptor searches as a share of their
roofline: the least time the card could take for every search of the
profiled batches (work/match.py, from the shapes) over the device time of
the kernels that ran them. Kernels read: K2 and K3's shared core and its
key-to-index pass."""
from benchmark.profiling import named
from benchmark.work import match

KERNELS = ("match_core::match_kernel", "match_core::key_low_words")


def read(r):
    events = named(r.trace.events_in("bench.forward_align"), KERNELS)
    if not events or not r.units:
        return None
    m, n = r.model, r.traffic["points"]
    extras = [s.strip() for s in m["inlier_extra_feats"].split(",") if s.strip()]
    bidir = "recip" in extras or m["mutual_check"]
    bound = match.bound_s(r.traffic["batch"], n, n, m["out_feat_dim"], bidir) \
        * r.forward["num_iter"] * r.units
    return 100.0 * bound / (sum(e.dur for e in events) * 1e-6)
