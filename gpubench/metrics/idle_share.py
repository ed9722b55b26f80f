"""Share of the traced window in which no kernel, memcpy or memset ran on
the card, percent."""


def read(rec):
    return 100.0 * (1.0 - rec.busy_us() / rec.window_us)
