"""``port_bench/spans.py`` on hand-made spans and device ops: attribution
by correlation id and launch time (a launch from a second thread too),
the whole-batch and untraced-batch rules, gaps named by host activity,
and readers that find nothing without spans."""

import pytest

from port_bench import spans as sp

MAIN, AUTOGRAD = 11, 22
US = 1000  # ns


def _span(name, start, end, parent, batch, **attrs):
    return {"name": name, "start_ns": start * US, "end_ns": end * US,
            "parent": parent, "tid": MAIN, "batch": batch, "attrs": attrs}


def _spans():
    """The benchmark's loop (submit i + 1, then the result of i): batch 6
    submits before the trace starts (50 us); batch 7 lies wholly inside
    it; batch 8's result ends after it stops (500 us)."""
    return [
        _span("runner.submit", 0, 90, -1, 6),                 # 0
        _span("runner.submit", 100, 200, -1, 7, images=2),    # 1
        _span("runner.upload", 100, 110, 1, 7),               # 2
        _span("drop.round", 110, 149, 1, 7, r=0),             # 3
        _span("vit.encode", 112, 120, 3, 7),                  # 4
        _span("bert.gradcam", 120, 140, 3, 7),                # 5
        _span("drop.select", 140, 149, 3, 7),                 # 6
        _span("runner.post", 151, 190, 1, 7),                 # 7
        _span("post.blur", 151, 160, 7, 7),                   # 8
        _span("post.crf", 160, 190, 7, 7, images=2),          # 9
        _span("runner.result", 205, 260, -1, 6),              # 10
        _span("runner.submit", 265, 290, -1, 8),              # 11
        _span("runner.result", 300, 400, -1, 7),              # 12
        _span("runner.result", 410, 600, -1, 8),              # 13
    ]


def _events():
    # (name, device start, device end, correlation id) and each op's
    # launch call (name, host start, host end, thread).
    ops = [("void flash_kernel<64>(Params)", 116, 130, 1),
           ("tap_backward_gemm", 131, 150, 2),
           ("Memcpy HtoD (Pageable -> Device)", 104, 106, 3),
           ("crf_iter_kernel", 200, 240, 4),
           ("blur_gemm", 165, 180, 5),
           ("direct_copy_kernel", 262, 263, 6),  # launched outside spans
           ("orphan_kernel", 264, 265, 7),  # no call in the trace
           ("Memcpy DtoH (Device -> Pageable)", 310, 320, 8)]
    calls = {1: ("cudaLaunchKernel", 115, 116, MAIN),
             2: ("cuLaunchKernel", 125, 126, AUTOGRAD),
             3: ("cudaMemcpyAsync", 103, 104, MAIN),
             4: ("cudaLaunchKernel", 170, 171, MAIN),
             5: ("cudaLaunchKernel", 155, 156, MAIN),
             6: ("cudaLaunchKernel", 261, 262, MAIN),
             8: ("cudaMemcpyAsync", 305, 321, MAIN)}
    scale = [(n, s * US, e * US, c) for n, s, e, c in ops]
    return {"ops": sorted(scale, key=lambda o: o[1]),
            "calls": {c: (n, s * US, e * US, t)
                      for c, (n, s, e, t) in calls.items()}}


def _ctx():
    return {"spans": {"spans": _spans(), "counters": {},
                      "window_ns": [0, 700 * US]},
            "trace": {"events": _events(), "traced_ns": [50 * US, 500 * US]}}


def test_ops_go_to_the_innermost_span_at_their_launch():
    spans, events = _spans(), _events()
    got = {o[0]: spans[i]["name"] if i >= 0 else None
           for o, i in zip(events["ops"], sp.attribute(spans, events))}
    assert got == {
        "void flash_kernel<64>(Params)": "vit.encode",
        # launched from the autograd thread while the submitting thread
        # waits inside bert.gradcam
        "tap_backward_gemm": "bert.gradcam",
        "Memcpy HtoD (Pageable -> Device)": "runner.upload",
        "crf_iter_kernel": "post.crf",
        "blur_gemm": "post.blur",
        "direct_copy_kernel": None,
        "orphan_kernel": None,
        "Memcpy DtoH (Device -> Pageable)": "runner.result",
    }


def test_spans_of_other_threads_are_not_searched():
    spans = _spans() + [dict(_span("worker", 100, 200, -1, None),
                             tid=AUTOGRAD)]
    events = _events()
    names = [spans[i]["name"] for i in sp.attribute(spans, events) if i >= 0]
    assert "worker" not in names and "bert.gradcam" in names


def test_whole_and_untraced_batches():
    spans = _spans()
    assert sp.whole_batches(spans, 50 * US, 500 * US) == {7}
    assert sp.untraced_batches(spans, [0, 700 * US], [50 * US, 500 * US]) \
        == set()
    assert sp.untraced_batches(spans, [0, 700 * US], None) == {6, 7, 8}
    assert sp.untraced_batches(spans, [0, 700 * US], [500 * US, 550 * US]) \
        == {6, 7}


def test_device_ms_and_launch_calls_count_whole_batches_only():
    ctx = _ctx()
    assert sp.kernel_ms(ctx, "bert.gradcam") == pytest.approx(19e-3)
    assert sp.kernel_ms(ctx, "vit.encode") == pytest.approx(14e-3)
    # post.blur's and post.crf's ops count under runner.post
    assert sp.kernel_ms(ctx, "runner.post") == pytest.approx(55e-3)
    # batch 7's ops: flash, tap backward, upload, crf, blur and the D2H
    assert sp.launch_calls(ctx) == 6
    b = sp.breakdown(ctx)
    assert b["batches"] == 1
    assert b["by_span"]["runner.result"] == pytest.approx(10e-3)
    assert b["by_span_kernel"]["post.crf crf_iter_kernel"] == \
        pytest.approx(40e-3)
    named = 14 + 19 + 2 + 40 + 15 + 10
    assert b["attributed_share"] == pytest.approx(named / (named + 2))


def test_host_ms_reads_untraced_batches():
    ctx = _ctx()
    ctx["trace"]["traced_ns"] = [500 * US, 550 * US]
    # batches 6 and 7 (batch 8 ends in the traced stretch)
    assert sp.host_ms(ctx, "runner.submit") == pytest.approx(95e-3)
    assert sp.host_ms(ctx, "runner.result") == pytest.approx(77.5e-3)


def test_idle_gaps_are_named_by_host_activity():
    # The ops cover [104,106] [116,130] [131,150] [165,180] [200,240]
    # [262,263] [264,265] [310,320] us; each gap is named by the innermost
    # span open at its start.
    assert sp.idle_gaps(_ctx()) == [
        ["runner.submit after orphan_kernel", pytest.approx(45e-6)],
        ["runner.result after crf_iter_kernel", pytest.approx(22e-6)],
        ["post.crf after blur_gemm", pytest.approx(20e-6)],
        ["runner.submit after tap_backward_gemm", pytest.approx(15e-6)],
        ["runner.upload after Memcpy HtoD ", pytest.approx(10e-6)],
        ["bert.gradcam after flash_kernel<64>", pytest.approx(1e-6)],
        ["(outside) after direct_copy_kernel", pytest.approx(1e-6)],
    ]


def test_a_gap_outside_every_span():
    ctx = _ctx()
    ctx["trace"]["events"]["ops"] += [("late_a", 601 * US, 605 * US, 9),
                                      ("late_b", 900 * US, 901 * US, 10)]
    assert sp.idle_gaps(ctx, top=2) == [
        ["(outside) after late_a", pytest.approx(295e-6)],
        ["runner.result after Memcpy DtoH ", pytest.approx(281e-6)]]


@pytest.mark.parametrize("ctx", [
    {}, {"spans": None, "trace": None},
    {"spans": {"spans": [], "counters": {}, "window_ns": [0, 1]},
     "trace": {"events": _events(), "traced_ns": [0, 1]}},
    {"spans": {"spans": _spans(), "counters": {}, "window_ns": [0, 1]},
     "trace": None},
])
def test_readers_find_nothing_without_spans_or_trace(ctx):
    assert sp.kernel_ms(ctx, "runner.post") is None
    assert sp.launch_calls(ctx) is None
    assert sp.breakdown(ctx) is None
    assert sp.idle_gaps(ctx) is None
    if not (ctx.get("spans") or {}).get("spans"):
        assert sp.host_ms(ctx, "runner.submit") is None
