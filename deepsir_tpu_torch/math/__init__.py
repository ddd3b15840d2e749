"""SE(3) helpers on torch tensors and on the host, and the random transforms
of the data layer."""
