"""The port's utils (viz, logging, tracing) against the JAX package's.

``viz`` on ``tests/test_viz.py``'s cases must give equal arrays and the same
files; ``SmoothedValue`` / ``MetricLogger`` the same values and lines;
the port's own ``Tracer`` (spans and counters, off by default) keeps the
summary structure of the JAX package's.
"""

import threading
import time

import numpy as np
import pytest
from PIL import Image

from pnp_ovss_tpu.utils import logging as jlog
from pnp_ovss_tpu.utils import viz as jviz
from pnp_ovss_tpu_torch.utils import logging as plog
from pnp_ovss_tpu_torch.utils import tracing as ptrace
from pnp_ovss_tpu_torch.utils import viz as pviz


@pytest.mark.parametrize("blur", [None, 1.0])
def test_attention_overlay_equals_jax(blur):
    rng = np.random.RandomState(0)
    img = rng.rand(32, 48, 3).astype(np.float32)
    att = rng.rand(4, 6).astype(np.float32)
    got = pviz.attention_overlay(img, att, blur_sigma=blur)
    np.testing.assert_array_equal(
        got, jviz.attention_overlay(img, att, blur_sigma=blur))
    assert got.shape == (32, 48, 3) and 0 <= got.min() and got.max() <= 1


def test_render_segmentation_and_colormap_equal_jax():
    rng = np.random.RandomState(1)
    img = rng.rand(16, 16, 3).astype(np.float32)
    labels = np.zeros((16, 16), np.int32)
    labels[4:8, 4:8] = 5
    labels[10:, 10:] = 300  # past the colormap: clipped
    for args in ((labels,), (labels, img)):
        np.testing.assert_array_equal(pviz.render_segmentation(*args),
                                      jviz.render_segmentation(*args))
    np.testing.assert_array_equal(pviz.label_colormap(10),
                                  jviz.label_colormap(10))
    np.testing.assert_array_equal(pviz.label_colormap(10)[0], 0.0)


def test_dump_debug_artifacts_equal_jax(tmp_path):
    rng = np.random.RandomState(2)
    args = ("imgX", rng.rand(20, 20, 3).astype(np.float32),
            rng.rand(2, 5, 5).astype(np.float32), ["dog", "cat"],
            rng.randint(0, 3, (20, 20)))
    gt = rng.randint(0, 3, (20, 20))
    pviz.dump_debug_artifacts(str(tmp_path / "p"), *args, gt_labels=gt)
    jviz.dump_debug_artifacts(str(tmp_path / "j"), *args, gt_labels=gt)
    names = sorted(p.name for p in (tmp_path / "p" / "viz").iterdir())
    assert names == ["attn_imgX_cat.jpeg", "attn_imgX_dog.jpeg",
                     "gt_imgX.jpeg", "seg_imgX.jpeg"]
    for name in names:
        a = np.asarray(Image.open(tmp_path / "p" / "viz" / name))
        b = np.asarray(Image.open(tmp_path / "j" / "viz" / name))
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_smoothed_value_equals_jax():
    got, want = plog.SmoothedValue(window_size=4), \
        jlog.SmoothedValue(window_size=4)
    for i, v in enumerate([3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0]):
        got.update(v, n=1 + i % 2)
        want.update(v, n=1 + i % 2)
    for attr in ("median", "avg", "global_avg", "count", "total"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert str(got) == str(want)
    got.synchronize_between_processes()  # no process group: unchanged
    assert (got.count, got.total) == (want.count, want.total)


def test_metric_logger_equals_jax(capsys):
    loggers = plog.MetricLogger(), jlog.MetricLogger()
    for lg in loggers:
        for v in (0.5, 0.25, 0.75):
            lg.update(host_s=v, device_s=2 * v)
    assert str(loggers[0]) == str(loggers[1])
    assert list(loggers[0].log_every(range(5), 2, header="h")) == \
        list(range(5))
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4 and lines[0].startswith("h [0/5] eta:")
    assert lines[-1].startswith("h done in")
    assert plog.is_main_process() and plog.get_world_size() == 1
    plog.log("shown")
    assert capsys.readouterr().out == "shown\n"


@pytest.fixture
def tracer():
    """The process-wide tracer, on for the test, off and empty after."""
    ptrace.TRACER.drain()
    ptrace.TRACER.enable()
    yield ptrace.TRACER
    ptrace.TRACER.disable()
    ptrace.TRACER.drain()


def test_tracer_off_records_nothing():
    t = ptrace.Tracer()
    assert not t.enabled and not ptrace.TRACER.enabled
    first = t.span("a", batch=3, x=1)
    assert first is t.span("b") is ptrace.TRACER.span("c")
    with first as got:
        t.count("n", 5)
    assert got is None
    assert t.drain() == {"spans": [], "counters": {}}
    assert t.summary() == {}
    assert t.new_batch() + 1 == t.new_batch()


def test_tracer_spans_nest_count_and_summarise(tracer):
    batch = tracer.new_batch()
    with tracer.span("outer", batch=batch, images=2):
        for r in range(3):
            with tracer.span("inner", r=r):
                tracer.count("n")
        tracer.count("n", 4)
        # A span on another thread does not nest under this thread's.
        done = []

        def side():
            with tracer.span("side"):
                done.append(threading.get_ident())
        th = threading.Thread(target=side)
        th.start()
        th.join(timeout=10)
        assert done
    with tracer.span("root2"):
        pass
    summary = tracer.summary()
    assert set(summary) == {"outer", "inner", "side", "root2"}
    assert summary["inner"]["count"] == 3 and summary["outer"]["count"] == 1
    assert all(set(s) == {"total_s", "count", "mean_s"}
               for s in summary.values())
    data = tracer.drain()
    spans = data["spans"]
    assert [s["name"] for s in spans] == ["outer", "inner", "inner", "inner",
                                          "side", "root2"]
    assert [s["parent"] for s in spans] == [-1, 0, 0, 0, -1, -1]
    assert [s["batch"] for s in spans] == [batch] * 4 + [None, None]
    assert [s["attrs"] for s in spans[:4]] == [
        {"images": 2}, {"r": 0}, {"r": 1}, {"r": 2}]
    main = threading.get_ident()
    assert [s["tid"] for s in spans] == [main] * 4 + [done[0], main]
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
    for s in spans[1:4]:
        assert spans[0]["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= spans[0]["end_ns"]
    assert abs(spans[0]["start_ns"] - time.time_ns()) < 60e9
    assert data["counters"] == {"n": 7}
    assert tracer.drain() == {"spans": [], "counters": {}}
