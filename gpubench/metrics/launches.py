"""Device operations (kernels, memcpys, memsets) in the trace per traced
frame or step."""


def read(rec):
    return rec.launches() / rec.n_items
