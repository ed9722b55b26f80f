"""The traced run's record, on a toy trace: the window, busy time, the
program's kernels against the libraries', launches and the breakdown."""

from gpubench import tracing

EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": tracing.ITEM_SPAN,
     "ts": 0, "dur": 100},
    {"ph": "X", "cat": "kernel", "ts": 10, "dur": 20,
     "name": "void rk4_fwd_kernel<1, false, 2>(float const*)"},
    {"ph": "X", "cat": "kernel", "ts": 25, "dur": 20,
     "name": "void at::native::vectorized_elementwise_kernel<4>(int)"},
    {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 46, "dur": 30},
    {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 40, "dur": 55},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 80,
     "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "void late(int)", "ts": 120,
     "dur": 5},
]


def test_record_reads_the_window():
    rec = tracing.Record(EVENTS, 2, None)
    assert rec.window_us == 100 and rec.busy_us() == 45
    assert rec.launches() == 3
    assert rec.kernel_us("rk4_fwd_kernel") == 20
    assert rec.library_kernel_us() == 20
    got = rec.breakdown()
    assert got["device_ops"][0] == ["rk4_fwd_kernel", 2e-05]
    assert dict(got["idle_gaps"]) == {"aten::mul": 3.5e-05,
                                      "host, no operator": 1e-05,
                                      "outer": 1e-05}


def test_program_kernels_are_found_by_name():
    names = tracing.program_kernels()
    for k in ("rk4_fwd", "rk4_ckpt", "rk4_bwd", "dopri_fwd", "dopri_ckpt",
              "dopri_bwd"):
        assert f"{k}_kernel" in names
    assert tracing.kernel_name(
        "void (anonymous namespace)::dopri_bwd_kernel<true, 3>(float*)"
    ) == "dopri_bwd_kernel"
