"""Device milliseconds per traced step of the forward render outside the
integrator: the operations of ``bhgc.step.render`` itself,
``bhgc.render.rays`` (the camera) and ``bhgc.render.shade`` (the shading
and its texture gathers)."""

from gpubench import spans


def read(rec):
    return spans.span_ms(rec, ("bhgc.step.render", "bhgc.render.rays",
                               "bhgc.render.shade"))
