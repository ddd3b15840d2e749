"""SemanticKITTI labels (deepsir_tpu/data/semantic_kitti.py): the learning
map of the 34 raw label ids onto 20 training classes (0 = unlabelled,
ignored), from the dataset's published semantic-kitti.yaml.
"""
from __future__ import annotations

import numpy as np

LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}

CLASS_NAMES = {
    0: "unlabeled", 1: "car", 2: "bicycle", 3: "motorcycle", 4: "truck",
    5: "other-vehicle", 6: "person", 7: "bicyclist", 8: "motorcyclist",
    9: "road", 10: "parking", 11: "sidewalk", 12: "other-ground",
    13: "building", 14: "fence", 15: "vegetation", 16: "trunk",
    17: "terrain", 18: "pole", 19: "traffic-sign",
}

_LUT = np.zeros(260, dtype=np.uint8)       # over the raw ids, the largest 259
for _raw, _mapped in LEARNING_MAP.items():
    _LUT[_raw] = _mapped


def remap_labels(raw_labels: np.ndarray) -> np.ndarray:
    """Raw semantic ids (the lower 16 bits) -> 0..19."""
    return _LUT[np.clip(raw_labels, 0, 259)]


def read_label_file(path: str) -> np.ndarray:
    """A .label file's per-point classes: the semantic id in the lower 16
    bits of each int32 (the instance id in the upper 16), remapped."""
    return remap_labels(np.fromfile(path, dtype=np.int32) & 0xFFFF)
