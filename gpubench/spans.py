"""The program's spans in a traced run, and the device's work and idle time
put down to them.

The port opens a ``record_function`` span (``utils.profiling.annotate``)
named ``bhgc.*`` at each layer boundary of a Trainer step and of a render.
Each device operation of the traced window belongs to exactly one span:
the innermost ``bhgc.*`` span open, on the thread that launched the
operation, at its launch.  The launch is the CUDA API call with the
operation's ``correlation`` and the thread that of the host operator with
the operation's ``External id`` (the innermost operator or span open over
that call); where the trace has no such call, the operator's start is the
moment.  An operation launched on a thread with no ``bhgc.*`` span open
(autograd's device thread outside the program's backward spans) belongs
to the innermost ``bhgc.*`` span open on any thread at that moment; what
is left is unattributed, and an operation with neither link is unmatched.
So a span's time is exclusive: its children's operations are theirs.

``tracing.Record`` keeps no links, so they are read from the profiler
itself: ``links`` finds the stopped ``torch.profiler.profile`` whose
traced window is the record's (still alive while the readers run) and
reads its events once per record.  ``attach`` gives a record the links of
a Chrome trace instead (the tests).
"""

from __future__ import annotations

import collections
import gc
import re

from gpubench import tracing

PREFIX = "bhgc."
CALL_CATS = ("cuda_runtime", "cuda_driver")
OP_CATS = ("cpu_op", "user_annotation")


def _links(rows) -> dict:
    """The links of the rows (cat, name, ts, dur, tid, correlation,
    External id) of one trace, in its traced window: ``device`` (name,
    ts, dur, correlation, External id), ``calls`` (correlation -> start,
    External id), ``ops`` (External id -> thread, start) and ``spans``
    (name, start, end, thread)."""
    items = [(ts, ts + dur) for cat, name, ts, dur, *_ in rows
             if cat == "user_annotation" and name == tracing.ITEM_SPAN]
    if not items:
        return None
    t0, t1 = min(a for a, _ in items), max(b for _, b in items)
    out = {"window_us": t1 - t0, "device": [], "calls": {}, "ops": {},
           "spans": []}
    for cat, name, ts, dur, tid, corr, ext in rows:
        if cat in tracing.DEVICE_CATS:
            if ts + dur > t0 and ts < t1:
                out["device"].append((tracing.kernel_name(name)
                                      if cat == "kernel" else cat,
                                      ts, dur, corr, ext))
        elif cat in CALL_CATS:
            if corr:
                out["calls"][corr] = (ts, ext)
        elif cat in OP_CATS:
            if ext:
                out["ops"][ext] = (tid, ts)
            if name.startswith(PREFIX):
                out["spans"].append((name, ts, ts + dur, tid))
    return out


def from_chrome(events: list) -> dict | None:
    """The links of a Chrome trace's events, as ``torch.profiler`` exports
    them."""
    rows = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        args = e.get("args") or {}
        rows.append((e.get("cat"), e["name"], float(e["ts"]),
                     float(e["dur"]), e.get("tid"), args.get("correlation"),
                     args.get("External id")))
    return _links(rows)


# a CUDA runtime or driver call, by name (``cudaLaunchKernel``,
# ``cuLaunchKernel``); the card's synchronisation records, which the
# trace keeps apart from its kernels
_CALL = re.compile(r"cu(da)?[A-Z]")
_SYNC = re.compile(r"((Context|Stream|Event) Sync|Stream Wait Event)$")


def _categories(events) -> list:
    """Each kineto event's category as the Chrome trace names it (None for
    one the links do not need): ``activity_type`` where torch has it, else
    read off what every version has.  A device event named as a host
    annotation is that annotation's range on the card; a host event linked
    to an operator is a CUDA call; an unlinked host event with no device
    index is the profiler's own overhead."""
    if events and hasattr(events[0], "activity_type"):
        return [k.activity_type() for k in events]
    from torch.autograd import DeviceType

    notes = {k.name() for k in events
             if k.device_type() == DeviceType.CPU and k.is_user_annotation()}
    out = []
    for k in events:
        name = k.name()
        if k.device_type() != DeviceType.CPU:
            out.append(None if name in notes or _SYNC.match(name) else
                       "gpu_memcpy" if name.startswith("Memcpy") else
                       "gpu_memset" if name.startswith("Memset") else
                       "kernel")
        elif k.is_user_annotation():
            out.append("user_annotation")
        elif k.linked_correlation_id() or _CALL.match(name):
            out.append("cuda_runtime")
        else:
            out.append("cpu_op" if k.device_index() >= 0 else None)
    return out


def from_profiler(prof) -> dict | None:
    """The links of a stopped ``torch.profiler.profile``, from its kineto
    events.  A kineto event's ``correlation_id`` is the operator's
    ``External id`` (for a device operation or a CUDA call, its own
    ``correlation``), and its ``linked_correlation_id`` the ``External
    id`` of the operator it was launched in."""
    result = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if result is None:
        return None
    events = list(result.events())
    if not events:
        return None
    # nanoseconds since the epoch lose a quarter microsecond as a float:
    # count from the first event
    base, rows = min(k.start_ns() for k in events), []
    for k, cat in zip(events, _categories(events)):
        if cat is None:
            continue
        own, linked = k.correlation_id(), k.linked_correlation_id()
        if cat in OP_CATS:
            corr, ext = None, own
        else:
            corr, ext = own, linked
        rows.append((cat, k.name(), (k.start_ns() - base) / 1e3,
                     k.duration_ns() / 1e3, k.start_thread_id(), corr, ext))
    return _links(rows)


def _live_profiler_links(rec) -> dict | None:
    """The links of the stopped profiler whose traced window is ``rec``'s,
    found among the live objects."""
    import torch.profiler

    for obj in gc.get_objects():
        # the type alone: no attribute of an arbitrary object is read
        if not issubclass(type(obj), torch.profiler.profile):
            continue
        got = from_profiler(obj)
        if (got is not None
                and abs(got["window_us"] - rec.window_us) < 0.5
                and len(got["device"]) == len(rec.device)):
            return got
    return None


def attach(rec, links: dict | None):
    """Give ``rec`` these links (a Chrome trace's, or a profiler's)."""
    rec._span_links = links
    rec._span_attribution = None
    return rec


def _opened(rec) -> list:
    """The names of the program's spans among the record's host events."""
    return sorted({name for name, _, _ in rec.host
                   if name.startswith(PREFIX)})


def links(rec) -> dict | None:
    """The record's links; None when the trace holds no span of the
    program, or no profiler of its window is alive."""
    if not hasattr(rec, "_span_links"):
        attach(rec, _live_profiler_links(rec) if _opened(rec) else None)
    return rec._span_links


def _innermost(spans, t, tid=None):
    """The name of the shortest span open at ``t`` (on thread ``tid``,
    or on any thread), or None."""
    open_ = [s for s in spans if s[1] <= t < s[2]
             and (tid is None or s[3] == tid)]
    return min(open_, key=lambda s: s[2] - s[1])[0] if open_ else None


def launch(got: dict, corr, ext):
    """An operation's launch: (moment, thread), the thread None where no
    operator is linked; None where neither link is in the trace."""
    call = got["calls"].get(corr)
    op = got["ops"].get(ext or (call[1] if call else None))
    if call is None and op is None:
        return None
    return (call[0] if call else op[1]), (op[0] if op else None)


def attribute(rec) -> dict | None:
    """Each span's exclusive device microseconds and operations over the
    window (and its microseconds by operation name), with the unattributed
    and the unmatched (no launching call or operator found) device time
    and the window's total.  None when the trace holds no span of the
    program."""
    got = links(rec)
    if got is None or not got["spans"]:
        return None
    if rec._span_attribution is not None:
        return rec._span_attribution
    spans = got["spans"]
    by_span = collections.defaultdict(
        lambda: [0.0, 0, collections.Counter()])
    out = {"unattributed_us": 0.0, "unmatched_us": 0.0, "total_us": 0.0}
    for op, _, dur, corr, ext in got["device"]:
        out["total_us"] += dur
        found = launch(got, corr, ext)
        if found is None:
            out["unmatched_us"] += dur
            out["unattributed_us"] += dur
            continue
        t, tid = found
        name = ((_innermost(spans, t, tid) if tid is not None else None)
                or _innermost(spans, t))
        if name is None:
            out["unattributed_us"] += dur
            continue
        entry = by_span[name]
        entry[0] += dur
        entry[1] += 1
        entry[2][op] += dur
    out["spans"] = {n: {"us": us, "ops": k, "by_name": dict(c)}
                    for n, (us, k, c) in sorted(by_span.items())}
    out["opened"] = sorted({s[0] for s in spans})
    rec._span_attribution = out
    return out


def span_ms(rec, names) -> float | None:
    """Device milliseconds per traced item attributed to the spans
    ``names`` themselves; None when none of them opened in the trace."""
    got = attribute(rec)
    if got is None or not set(names) & set(got["opened"]):
        return None
    return sum(got["spans"].get(n, {"us": 0.0})["us"]
               for n in names) / 1e3 / rec.n_items


def gap_labels(rec) -> list:
    """The window's idle gaps, (label, microseconds), each labelled as
    ``Record.breakdown`` labels it: the innermost host event, on any
    thread, open over the gap's middle."""
    idle, edge = [], rec.t0
    for a, b in rec.busy_intervals() + [[rec.t1, rec.t1]]:
        if a > edge:
            idle.append((0.5 * (edge + a), a - edge))
        edge = max(edge, b)
    hosts = sorted(rec.host, key=lambda h: h[1])
    out, active, j = [], [], 0
    for mid, length in sorted(idle):
        while j < len(hosts) and hosts[j][1] <= mid:
            active.append(hosts[j])
            j += 1
        active = [h for h in active if h[1] + h[2] >= mid]
        out.append((min(active, key=lambda h: h[2])[0] if active
                    else None, length))
    return out


def host_gap_ms(rec) -> float | None:
    """Idle milliseconds per traced item whose gap has one of the
    program's spans as the innermost open host event, so no operator or
    CUDA call is open there: host Python of the program that the card
    waits for (``breakdown``'s ``idle_gaps`` labelled ``bhgc.*``).  None
    when the trace holds no span of the program.  It reads the record
    alone: no links."""
    if not _opened(rec):
        return None
    return sum(length for label, length in gap_labels(rec)
               if label is not None and label.startswith(PREFIX)
               ) / 1e3 / rec.n_items
