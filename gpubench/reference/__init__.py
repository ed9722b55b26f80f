"""The plain reference: plain PyTorch, a frozen copy of the port's plain
path, importing nothing of the program or of JAX."""
