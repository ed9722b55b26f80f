"""Device milliseconds per traced step of the shading's backward: the
operations launched in the program's ``bhgc.shade.backward`` spans (the
shading kernel's per-ray cotangents and the scene's column sums), outside
its texture scatter's ``bhgc.texture.backward``.  A program without that
span reads None."""

from gpubench import spans


def read(rec):
    return spans.span_ms(rec, ("bhgc.shade.backward",))
