"""Device time, per pair, of what `training.device_batch` launched in the
profiled label training steps: the host-to-device copies (the program's span
`deepsir.h2d`) and both clouds' index pyramids (`deepsir.pyramid`:
`ops/pyramid.py` -> `ops/knn.py` -> K1)."""
from benchmark.profiling import device_ms
from benchmark.program_spans import events


def read(r):
    mine = events(r, "deepsir.h2d") + events(r, "deepsir.pyramid")
    return device_ms(mine) / r.pairs if mine and r.pairs else None
