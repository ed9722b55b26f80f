"""Device milliseconds per traced step of the integrator: the operations
launched in ``bhgc.render.integrate`` (the forward kernel and its set-up)
and ``bhgc.integrate.backward`` (the adjoint kernel and its set-up)."""

from gpubench import spans


def read(rec):
    return spans.span_ms(rec, ("bhgc.render.integrate",
                               "bhgc.integrate.backward"))
