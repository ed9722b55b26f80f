"""Device milliseconds per traced step of autograd's own backward: the
operations of ``bhgc.step.backward`` outside the program's backward spans
(the backward of the shading, the camera and the scene)."""

from gpubench import spans


def read(rec):
    return spans.span_ms(rec, ("bhgc.step.backward",))
