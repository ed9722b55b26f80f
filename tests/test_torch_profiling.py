"""The port's utils/profiling.py on torch.profiler against the JAX
package's (the twins of tests/test_io_cli.py's profiling tests).

On the CPU the trace holds the host's operators, nested; the op table
counts each by its self time, so it never exceeds the traced wall time
and equals the profiler's own self-time sums.  The collective report is
held on a collective-free step and on a two-process gloo all_reduce; the
interval helpers equal the JAX ones on seeded random interval sets.
"""

import math
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blackhole_geodesic_calculator_tpu.utils import profiling as jprof  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.utils import profiling  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.utils.profiling import (  # noqa: E402
    _flat_pieces, _merge_intervals, _overlap_us, annotate,
    device_memory_stats, format_op_table, op_table, profile_collectives,
    profile_steps, trace)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def matmul_step(x):
    return (x @ x).sum()


def test_profile_steps_op_table():
    """Twin of test_profile_steps_op_table: rows with time, the header."""
    rows = profile_steps(matmul_step, torch.ones(256, 256), repeats=2,
                         top=5)
    assert rows, "no events captured"
    assert sum(ms for _, ms, _ in rows) > 0
    assert "aten::mm" in [name for name, _, _ in rows]
    txt = format_op_table(rows)
    assert "device ms/step" in txt and len(txt.splitlines()) >= 2
    assert format_op_table(rows) == jprof.format_op_table(rows)


def test_op_table_counts_self_time(tmp_path):
    """On the CPU the nested operators are counted by self time: the table
    never exceeds the traced wall time, and each row equals the profiler's
    own self-time sum for that operator."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(192, 192)
    matmul_step(x)
    repeats = 3
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(repeats):
            matmul_step(x)
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(tmp_path / "0.pt.trace.json"))
    rows = op_table(str(tmp_path), top=100, repeats=repeats)
    assert sum(ms for _, ms, _ in rows) * repeats <= wall_ms
    self_ms = {e.key: e.self_cpu_time_total / 1e3 / repeats
               for e in prof.key_averages()}
    for name, ms, count in rows:
        assert ms == pytest.approx(self_ms[name], rel=1e-3, abs=1e-5), name
    assert dict((n, c) for n, _, c in rows)["aten::mm"] == repeats


def test_flat_pieces_cut_nested_events():
    """A parent with two children becomes three pieces of its own time
    and the children whole; a child running past its parent is cut at the
    parent's end; other lanes stay apart."""
    evs = [("a", "p", 0.0, 10.0), ("a", "c", 2.0, 3.0),
           ("a", "d", 6.0, 6.0), ("b", "q", 1.0, 4.0)]
    pieces = _flat_pieces(evs)
    by = {}
    for lane, name, ts, dur in pieces:
        by[name] = by.get(name, 0.0) + dur
    assert by == {"p": 3.0, "c": 3.0, "d": 4.0, "q": 4.0}
    assert sorted((ts, dur) for lane, name, ts, dur in pieces
                  if name == "p") == [(0.0, 2.0), (5.0, 1.0)]


def test_collective_report_no_collectives():
    """Twin of test_collective_report_no_collectives: zero share, NaN
    overlap."""
    rep = profile_collectives(lambda x: (x * 2).sum(), torch.ones(128, 128),
                              repeats=1)
    assert rep["collective_ms"] == 0
    assert rep["collective_share"] == 0
    assert math.isnan(rep["overlap_fraction"])
    assert rep["top_collectives"] == [] and rep["compute_ms"] > 0


def random_intervals(rng):
    n = int(rng.integers(0, 12))
    s = np.round(rng.uniform(0, 100, n), 1)
    return [(float(a), float(a + d))
            for a, d in zip(s, np.round(rng.uniform(0, 20, n), 1))]


@pytest.mark.parametrize("helper", ["merge", "overlap"])
def test_interval_helpers_match_jax(helper):
    """The interval helpers are the JAX package's: equal outputs on 200
    seeded random interval sets (touching and nested intervals among
    them, from the rounding)."""
    rng = np.random.default_rng(13)
    for _ in range(200):
        ivals = random_intervals(rng)
        if helper == "merge":
            assert _merge_intervals(ivals) == jprof._merge_intervals(ivals)
        else:
            merged = jprof._merge_intervals(ivals)
            for q in random_intervals(rng):
                assert _overlap_us(q, merged) == jprof._overlap_us(q, merged)


def test_trace_annotate_and_memory_stats(tmp_path):
    """``trace`` writes a Chrome trace that holds ``annotate``'s span;
    without a card the memory stats are the JAX package's None entry."""
    with trace(str(tmp_path)):
        with annotate("bhgc_span"):
            matmul_step(torch.ones(32, 32))
    events = profiling._load_trace_events(str(tmp_path))
    assert any(e.get("name") == "bhgc_span" for e in events)
    with pytest.raises(FileNotFoundError):
        profiling._load_trace_events(str(tmp_path / "empty"))
    if not torch.cuda.is_available():
        assert device_memory_stats() == {"cpu": None}


WORKER = r"""
import sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from blackhole_geodesic_calculator_tpu_torch.utils.profiling import (
    profile_collectives)

port, rank = sys.argv[1], int(sys.argv[2])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
x = torch.ones(128, 128)

def step(x):
    y = (x @ x).sum(0)
    dist.all_reduce(y)
    return y

rep = profile_collectives(step, x, repeats=2)
dist.destroy_process_group()
names = " ".join(n for n, _ in rep["top_collectives"])
print(f"RESULT share={rep['collective_share']!r} "
      f"overlap={rep['overlap_fraction']!r} names={names}")
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_collective_report_two_rank_gloo(tmp_path):
    """Twin of test_collective_report_sharded_step: two gloo processes
    all_reduce a matmul's row sums; the report finds the collective, a
    share strictly between 0 and 1, and an overlap in [0, 1]."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, str(script), port, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        finally:
            p.kill()
        assert p.returncode == 0, err[-2000:]
        outs.append(out)
    for out in outs:
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][0]
        fields = dict(kv.split("=", 1) for kv in line.split()[1:3])
        share, overlap = float(fields["share"]), float(fields["overlap"])
        assert 0 < share < 1, line
        assert 0.0 <= overlap <= 1.0, line
        assert "allreduce" in line.split("names=")[1], line
