"""The program's spans on a toy trace: each device operation put down to
the innermost ``bhgc.*`` span open on its launching thread (its launching
call found by ``correlation``, its operator by ``External id``), autograd's
thread falling back to the span open on any thread, the unattributed and
unmatched rest, the idle gaps in the program's host Python, the six
readers; the links read back from a live profiler; and the existing
readers and ``breakdown()``, which the spans leave as they were."""

import copy

import pytest

import test_gpubench_tracing as T
from gpubench import harness, spans, tracing

MAIN, GRAD = 101, 202   # the main thread, autograd's device thread
READERS = ("texture_bwd_ms", "integrator_ms", "autograd_ms", "shading_ms",
           "trainer_ms", "host_gap_ms")


def user(name, ts, dur, tid=MAIN, ext=None):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid, "args": {"External id": ext}}


def op(name, ext, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": {"External id": ext}}


def call(corr, ts, tid=MAIN, ext=None):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 5, "pid": 1, "tid": tid,
            "args": {"correlation": corr, "External id": ext}}


def kernel(name, corr, ts, dur, ext=None, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7,
            "args": {"correlation": corr, "External id": ext}}


EVENTS = [
    user(tracing.ITEM_SPAN, 0, 1000),
    user("bhgc.step", 0, 900),
    user("bhgc.step.render", 10, 290),
    user("bhgc.render.integrate", 20, 80),
    user("bhgc.step.backward", 400, 400),
    user("bhgc.step.update", 820, 70),
    user("bhgc.texture.backward", 500, 100, tid=GRAD),
    op("aten::copy_", 76, 330, 40),
    op("aten::add", 77, 830, 10),
    op("aten::mul", 78, 545, 10),
    op("aten::mul", 79, 645, 10, tid=GRAD),
    op("aten::index_put_", 80, 505, 10, tid=GRAD),
    # runs after its span closed: the launching call's moment counts
    call(1, 30), kernel("void rk4_ckpt_kernel<1>(float*)", 1, 105, 50),
    call(2, 150), kernel("void at::native::elementwise_kernel<4>(int)", 2,
                         160, 20),
    call(3, 510, tid=GRAD, ext=80),
    kernel("void at::native::indexing_backward_kernel_small_stride<float>"
           "(float*)", 3, 520, 60, ext=80),
    # launched on the main thread while autograd's thread has a shorter
    # span open: the launching thread's span has it
    call(8, 548, ext=78),
    kernel("void at::native::reduce_kernel<512>(int)", 8, 585, 3, ext=78),
    # autograd's thread with no span of the program open
    call(4, 650, tid=GRAD, ext=79),
    kernel("void at::native::vectorized_elementwise_kernel<4>(int)", 4,
           660, 30, ext=79),
    # no launching call in the trace: found by the op's External id
    kernel("void at::native::reduce_kernel<512>(int)", 6, 845, 5, ext=77),
    # neither: unmatched
    kernel("void at::native::reduce_kernel<512>(int)", 7, 870, 4, ext=99),
    # launched after the step, inside the item: unattributed
    call(5, 950), kernel("Memcpy DtoH", 5, 960, 10, cat="gpu_memcpy"),
]


def record(events=EVENTS):
    rec = tracing.Record(copy.deepcopy(events), 2, None)
    return spans.attach(rec, spans.from_chrome(events))


def test_attributed_by_correlation():
    got = spans.attribute(record())["spans"]
    assert got["bhgc.render.integrate"] == {
        "us": 50.0, "ops": 1, "by_name": {"rk4_ckpt_kernel": 50.0}}
    assert got["bhgc.step.render"] == {
        "us": 20.0, "ops": 1,
        "by_name": {"at::native::elementwise_kernel": 20.0}}
    assert got["bhgc.texture.backward"]["us"] == 60.0


def test_external_id_fallback():
    got = spans.attribute(record())["spans"]["bhgc.step.update"]
    assert (got["us"], got["ops"]) == (5.0, 1)


def test_launching_threads_span_wins():
    """Launched from the main thread inside ``bhgc.step.backward`` while
    ``bhgc.texture.backward``, shorter, is open on autograd's thread."""
    got = spans.attribute(record())["spans"]["bhgc.step.backward"]
    assert got["by_name"]["at::native::reduce_kernel"] == 3.0


def test_autograd_thread_goes_to_the_span_open_on_any_thread():
    """Launched on the second thread with none of the program's spans
    open there: the main thread's innermost open span has it."""
    got = spans.attribute(record())["spans"]["bhgc.step.backward"]
    assert (got["us"], got["ops"]) == (33.0, 2)
    assert got["by_name"][
        "at::native::vectorized_elementwise_kernel"] == 30.0


def test_unattributed_and_unmatched_rest():
    got = spans.attribute(record())
    assert got["total_us"] == 182.0
    assert got["unmatched_us"] == 4.0
    assert got["unattributed_us"] == 14.0
    assert sum(s["us"] for s in got["spans"].values()) + got[
        "unattributed_us"] == got["total_us"]
    assert got["opened"] == sorted(
        e["name"] for e in EVENTS if e["name"].startswith("bhgc."))


def test_order_of_the_trace_does_not_matter():
    assert spans.attribute(record(list(reversed(EVENTS)))) == (
        spans.attribute(record()))


@pytest.mark.parametrize("metric,value", [
    ("texture_bwd_ms", 0.03), ("integrator_ms", 0.025),
    ("autograd_ms", 0.0165), ("shading_ms", 0.01),
    ("trainer_ms", 0.0025), ("host_gap_ms", 0.181)])
def test_readers(metric, value):
    """Exclusive device ms per item; the idle gaps in the program's spans
    (0-105, 155-160, 580-585, 588-660, 690-845, 850-870 us; the one
    under aten::copy_ and those after the step are not)."""
    assert harness.metric_reader(f"{metric}.fit")(record()) == (
        pytest.approx(value, rel=1e-12))


def test_host_gap_is_breakdowns_program_gaps():
    rec = record()
    gaps = dict(rec.breakdown()["idle_gaps"])
    assert set(gaps) == {"bhgc.render.integrate", "bhgc.step.render",
                         "aten::copy_", "bhgc.step.backward",
                         "bhgc.texture.backward", "bhgc.step.update",
                         "host, no operator"}
    ours = sum(v for k, v in gaps.items() if k.startswith("bhgc."))
    assert spans.host_gap_ms(rec) == pytest.approx(ours * 1e3 / 2)


def test_readers_give_nothing_without_the_programs_spans():
    """A program that opens no span (the parent of the spans) reads
    nothing, looks for no profiler, and nothing raises."""
    rec = tracing.Record(T.EVENTS, 2, None)
    for metric in READERS:
        assert harness.metric_reader(f"{metric}.fit")(rec) is None
    assert rec._span_links is None


def test_readers_give_nothing_without_links():
    """The program's spans in the record, but no profiler of its window
    alive: the device readers leave their metrics out."""
    rec = tracing.Record(copy.deepcopy(EVENTS), 2, None)
    for metric in READERS[:-1]:
        assert harness.metric_reader(f"{metric}.fit")(rec) is None
    assert harness.metric_reader("host_gap_ms.fit")(rec) == (
        pytest.approx(0.181))


def test_links_from_the_live_profiler():
    """A real (CPU) trace: the record's links are read back from the
    stopped profiler, and give the spans, their threads and their times
    that the Chrome trace gives, and each operator inside its span."""
    import torch

    prof = tracing.Profiler()
    with torch.profiler.record_function(tracing.ITEM_SPAN):
        with torch.profiler.record_function("bhgc.step"):
            with torch.profiler.record_function("bhgc.step.render"):
                torch.ones(64).add_(1.0)
            torch.ones(8).mul_(2.0)
    events = prof.stop()
    rec = tracing.Record(events, 1, None)
    got = spans.links(rec)
    assert got is not None
    chrome = spans.from_chrome(events)
    assert got["window_us"] == pytest.approx(chrome["window_us"], abs=0.5)

    def shape(links):
        t0 = min(s[1] for s in links["spans"])
        return sorted((s[0], s[1] - t0, s[2] - t0) for s in links["spans"])

    # the Chrome trace gives microseconds to three decimals
    for ours, theirs in zip(shape(got), shape(chrome), strict=True):
        assert ours[0] == theirs[0]
        assert ours[1:] == pytest.approx(theirs[1:], abs=0.01)
    assert [s[0] for s in shape(got)] == ["bhgc.step", "bhgc.step.render"]
    assert len({s[3] for s in got["spans"]}) == 1
    # every operator, found by its External id, opens on the spans'
    # thread inside the step
    step = next(s for s in got["spans"] if s[0] == "bhgc.step")
    assert len(got["ops"]) == len(chrome["ops"]) >= 6
    assert all(tid == step[3] and step[1] <= t < step[2]
               for tid, t in got["ops"].values()
               if t >= step[1])
    assert spans.attribute(rec)["total_us"] == 0.0
    del prof


class Kineto:
    """A kineto event of a torch without ``activity_type`` (2.11 on the
    card): what ``spans.from_profiler`` reads of one."""

    def __init__(self, name, cuda, corr, linked, tid, ts, dur,
                 note=False, index=118):
        from torch.autograd import DeviceType

        self._v = {"name": name, "correlation_id": corr,
                   "linked_correlation_id": linked, "start_thread_id": tid,
                   "start_ns": ts * 1000, "duration_ns": dur * 1000,
                   "is_user_annotation": note, "device_index": index,
                   "device_type": DeviceType.CUDA if cuda
                   else DeviceType.CPU}

    def __getattr__(self, name):
        if name == "_v":
            raise AttributeError(name)
        if name not in self._v:
            raise AttributeError(name)
        return lambda: self._v[name]


def profiler_of(events):
    from types import SimpleNamespace

    result = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=result))


# as the card's torch gives them (a probe of one step): the profiler's own
# overhead carries the id of the operator it fell in (here the step's and
# the multiply's), unlinked; the card keeps a range of each annotation and
# its synchronisations beside the kernels
OLD = [
    Kineto("gpubench.item", False, 1, 0, 1, 0, 1000, note=True),
    Kineto("bhgc.step", False, 2, 0, 1, 10, 890, note=True),
    Kineto("Lazy Function Loading", False, 2, 0, 1, 50, 10, index=-1),
    Kineto("Lazy Function Loading", False, 3, 0, 1, 105, 5, index=-1),
    Kineto("aten::mul", False, 3, 0, 1, 100, 100),
    Kineto("cudaLaunchKernel", False, 7, 3, 1, 120, 10),
    Kineto("void at::native::elementwise_kernel<4>(int)", True, 7, 3, 2,
           150, 10, index=0),
    Kineto("bhgc.step", True, 2, 0, 1, 150, 650, note=True, index=0),
    Kineto("Context Sync", True, 9, 0, 2, 400, 5, index=0),
    Kineto("aten::mul", False, 520, 0, 2, 300, 50),
    Kineto("cudaLaunchKernel", False, 71, 520, 2, 310, 10),
    Kineto("void at::native::vectorized_elementwise_kernel<4>(int)", True,
           71, 520, 2, 330, 20, index=0),
    Kineto("aten::copy_", False, 19, 0, 1, 700, 100),
    Kineto("cudaMemcpyAsync", False, 117, 19, 1, 710, 20),
    Kineto("Memcpy DtoH (Device -> Pageable)", True, 117, 19, 2, 720, 5,
           index=0),
    Kineto("cudaDeviceSynchronize", False, 123, 0, 1, 950, 20),
]


def test_categories_without_activity_type():
    assert spans._categories(OLD) == [
        "user_annotation", "user_annotation", None, None, "cpu_op",
        "cuda_runtime", "kernel", None, None, "cpu_op", "cuda_runtime",
        "kernel", "cpu_op", "cuda_runtime", "gpu_memcpy", "cuda_runtime"]


def test_links_without_activity_type():
    """The overhead that shares the step's id is no operator; each device
    operation finds its call and its operator's thread."""
    got = spans.from_profiler(profiler_of(OLD))
    assert got["window_us"] == 1000.0
    assert got["ops"][2] == (1, 10.0)
    assert [d[0] for d in got["device"]] == [
        "at::native::elementwise_kernel",
        "at::native::vectorized_elementwise_kernel", "gpu_memcpy"]
    assert got["calls"] == {7: (120.0, 3), 71: (310.0, 520),
                            117: (710.0, 19), 123: (950.0, 0)}
    assert got["spans"] == [("bhgc.step", 10.0, 900.0, 1)]
    assert [spans.launch(got, d[3], d[4]) for d in got["device"]] == [
        (120.0, 1), (310.0, 2), (710.0, 1)]


def test_both_torches_read_a_real_trace_alike():
    """A real (CPU) trace read with ``activity_type`` and without it."""
    import torch

    class Old:
        def __init__(self, k):
            self.k = k

        def __getattr__(self, name):
            if name == "activity_type":
                raise AttributeError(name)
            return getattr(self.k, name)

    prof = tracing.Profiler()
    with torch.profiler.record_function(tracing.ITEM_SPAN):
        with torch.profiler.record_function("bhgc.step"):
            torch.ones(64).add_(1.0)
    prof.stop()
    events = prof.prof.profiler.kineto_results.events()
    assert spans.from_profiler(profiler_of([Old(k) for k in events])) == (
        spans.from_profiler(prof.prof))


def with_links(events):
    """``events`` with the args a real trace carries on each."""
    out = copy.deepcopy(events)
    for i, e in enumerate(out):
        e["tid"] = MAIN if e["cat"] in tracing.HOST_CATS else 7
        e["args"] = {"correlation": 1000 + i, "External id": 2000 + i}
    return out


@pytest.mark.parametrize("events", [T.EVENTS, with_links(T.EVENTS)],
                         ids=["bare", "with_links"])
def test_existing_readers_and_breakdown_unchanged(events):
    """The four existing readers and ``breakdown()`` on the tracing test's
    events give the values they gave before the spans, with the links in
    the events or not, and reading the spans changes none of them."""
    rec = tracing.Record(copy.deepcopy(events), 2, None)
    for metric in READERS:
        harness.metric_reader(f"{metric}.fit")(rec)
    read = {m: harness.metric_reader(f"{m}.fit")(rec) for m in (
        "idle_share", "launches", "torch_ops_ms", "rk4_bwd_roofline")}
    assert read == {"idle_share": 55.00000000000001, "launches": 1.5,
                    "torch_ops_ms": 0.01, "rk4_bwd_roofline": None}
    assert rec.breakdown() == {
        "device_ops": [["rk4_fwd_kernel", 2e-05],
                       ["at::native::vectorized_elementwise_kernel", 2e-05],
                       ["gpu_memcpy", 1e-05]],
        "idle_gaps": [["aten::mul", 3.5e-05], ["host, no operator", 1e-05],
                      ["outer", 1e-05]]}
    assert rec.device == [
        ("rk4_fwd_kernel", "kernel", 10.0, 20.0),
        ("at::native::vectorized_elementwise_kernel", "kernel", 25.0, 20.0),
        ("gpu_memcpy", "gpu_memcpy", 80.0, 10.0)]
    assert rec.host == [("aten::mul", 46.0, 30.0), ("outer", 40.0, 55.0)]


def test_span_table_adds_up_on_the_toy_trace():
    """tools/span_table.py's table: the spans and the unattributed rest
    make up the window's device time; an operation that starts before
    its launching call shows as early."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "span_table", harness.HERE / "tools" / "span_table.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = mod.table(record())
    assert got["launch_to_start_us"]["early"] == 0
    early = copy.deepcopy(EVENTS)
    early[-1]["ts"] = 949       # the memcpy before its launching call
    lag = mod.launch_to_start(record(early))
    assert (lag["early"], lag["early_max_us"]) == (1, 1.0)
    assert lag["early_by_name"] == [("gpu_memcpy", 1)]
    assert got["checks"]["sum_vs_device"] == pytest.approx(1.0)
    assert got["checks"]["links_vs_record"] == pytest.approx(1.0)
    assert got["device_ms"] == pytest.approx(0.091)
    assert got["unmatched_share"] == pytest.approx(4 / 182)
    assert got["spans"]["bhgc.texture.backward"]["top"] == [
        ["at::native::indexing_backward_kernel_small_stride", 0.03]]
    assert got["threads"] == {
        str(MAIN): ["bhgc.render.integrate", "bhgc.step",
                    "bhgc.step.backward", "bhgc.step.render",
                    "bhgc.step.update"],
        str(GRAD): ["bhgc.texture.backward"]}
