"""The data layer: pair datasets, their augmentations and the batch loader
(deepsir_tpu/data)."""
