"""Device milliseconds per traced step of the trainer's own work: the
operations of ``bhgc.step`` itself, ``bhgc.step.scene``, ``bhgc.step.loss``
(the mask and the loss) and ``bhgc.step.update`` (the clip and Adam)."""

from gpubench import spans


def read(rec):
    return spans.span_ms(rec, ("bhgc.step", "bhgc.step.scene",
                               "bhgc.step.loss", "bhgc.step.update"))
