"""Training losses (deepsir_tpu/losses)."""
