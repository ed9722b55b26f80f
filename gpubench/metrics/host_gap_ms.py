"""Idle milliseconds per traced step in which the card waited for the
program's own host Python: the idle gaps whose middle lies in a ``bhgc.*``
span with no operator or CUDA call open."""

from gpubench import spans


def read(rec):
    return spans.host_gap_ms(rec)
