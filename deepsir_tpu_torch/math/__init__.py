"""SE(3) helpers on torch tensors."""
