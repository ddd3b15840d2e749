"""The plain PyTorch reference that decides `correct`: a frozen copy of the
port's plain paths, importing nothing of the port, JAX or the JAX package."""
