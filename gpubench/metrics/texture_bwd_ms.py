"""Device milliseconds per traced step of the texture backward: the
operations launched in the program's ``bhgc.texture.backward`` spans (the
accumulating ``index_put_`` scatters, their index sort, the coordinate
cotangents)."""

from gpubench import spans


def read(rec):
    return spans.span_ms(rec, ("bhgc.texture.backward",))
