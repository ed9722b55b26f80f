"""Device milliseconds per traced frame or step of the kernels that are
not the program's own (PyTorch's and its libraries')."""


def read(rec):
    return rec.library_kernel_us() / 1e3 / rec.n_items
