"""The plain Kerr reference: plain PyTorch, a frozen copy of ``reference/``
extended to a spinning hole, importing nothing of the program, of the
rest of the benchmark or of JAX."""
