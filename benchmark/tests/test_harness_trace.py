"""The trace reduction on a hand-made Chrome trace: busy union, window,
groups, and idle gaps named by what the host was doing."""

from benchmark import trace


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_summarize():
    events = [
        _ev("bench.dispatch", "user_annotation", 0, 50),
        _ev("aten::sort", "cpu_op", 40, 8),
        _ev("bench.wait", "user_annotation", 50, 200),
        _ev("void cb::conv_bf16_kernel<2, 128>(...)", "kernel", 10, 20),
        _ev("void cb::conv_bf16_kernel<2, 128>(...)", "kernel", 25, 10),   # overlaps
        _ev("decode_score_kernel", "kernel", 45, 5),
        _ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 60, 40),
        _ev("ac2g", "ac2g", 0, 1),
    ]
    t = trace.summarize(events, steps=2)
    assert abs(t.window_s - 90e-6) < 1e-12
    assert abs(t.busy_s - (25 + 5 + 40) * 1e-6) < 1e-12
    assert abs(t.groups["K5 bf16 conv (im2col A)"] - 30e-6) < 1e-12
    assert abs(t.groups["K1 decode+score"] - 5e-6) < 1e-12
    assert t.device_ops == 4
    assert [round(g[0] * 1e6) for g in t.gaps] == [10, 10]
    assert t.gaps[0][1] in ("bench.dispatch > aten::sort", "bench.wait")
    assert abs(trace.per_step_ms(t, trace.conv_group) - 30e-6 / 2 * 1e3) < 1e-12
    assert trace.per_step_ms(t, lambda g: g == "maxpool (SPP, the ladder)") is None


def test_no_device_operations():
    t = trace.summarize([_ev("bench.wait", "user_annotation", 0, 5)], steps=3)
    assert t.busy_s == 0.0 and t.window_s == 0.0 and trace.per_step_ms(t, trace.conv_group) is None
