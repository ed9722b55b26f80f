"""Device milliseconds per traced step of the disk's redshift and beaming:
the operations launched in ``bhgc.render.redshift`` (scene/shading.py
``shade_disk``), which opens only for a disk with a beaming exponent."""

from gpubench import spans


def read(rec):
    return spans.span_ms(rec, ("bhgc.render.redshift",))
