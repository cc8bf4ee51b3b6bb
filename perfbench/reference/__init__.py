"""The plain reference that decides ``correct``: NumPy and plain PyTorch
only. It imports nothing of the port and nothing of the JAX package, and
takes nothing the program made except the outputs it judges."""
