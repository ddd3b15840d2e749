"""The train command's summaries, as files (the JAX package's train.py writes
the same tags at the same steps to TensorBoard through tensorboardX).

`SummaryWriter(logdir)` appends each scalar as one JSON line {"tag",
"step", "value"} to `<logdir>/scalars.jsonl`, and writes each mesh to
`<logdir>/meshes/<tag>_<step>.npz` (arrays `vertices` and `colors`).
"""
from __future__ import annotations

import json
import os

import numpy as np


class SummaryWriter:
    """`add_scalar` and `add_mesh` with tensorboardX's signatures."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(os.path.join(logdir, "meshes"), exist_ok=True)
        self._scalars = os.path.join(logdir, "scalars.jsonl")

    def add_scalar(self, tag: str, scalar_value, global_step: int) -> None:
        with open(self._scalars, "a") as f:
            f.write(json.dumps({"tag": tag, "step": int(global_step),
                                "value": float(scalar_value)}) + "\n")

    def add_mesh(self, tag: str, vertices, colors, global_step: int) -> None:
        np.savez(os.path.join(self.logdir, "meshes", f"{tag}_{global_step}.npz"),
                 vertices=np.asarray(vertices), colors=np.asarray(colors))
