"""The port's spans (``obs/events.py``) and their join with a profiler
trace (``obs/profile.py``): nesting and parents, the totals in
``events()``, the no-op without an active log, the calls a log that is
not an ``EventLog`` gets, the shared clock with ``torch.profiler``, the
spans small solves record, the collectives' spans, and ``summarize`` on
synthetic events."""

import socket

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from eigenkernel_tpu_torch.obs import events
from eigenkernel_tpu_torch.obs.events import EventLog, span, stage
from eigenkernel_tpu_torch.obs.profile import summarize
from eigenkernel_tpu_torch.ops import dc
from eigenkernel_tpu_torch.solvers.api import solve

N = 150
BLOCK = 16
STAGE_PREFIXES = ("sep:", "solve:", "reduce_", "recovery_", "main:")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    torch.set_num_threads(2)


def _pencil(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    b = rng.standard_normal((n, n))
    return torch.tensor((a + a.T) / 2), torch.tensor(b @ b.T / n + np.eye(n))


def test_spans_nest_and_name_their_parents():
    log = EventLog(stream=False)
    with stage("sep:x", log):
        with span("a"):
            with span("b"):
                pass
            with span("b"):
                pass
    got = log.spans()
    assert [(s.name, s.parent) for s in got] == [
        ("b", "a"), ("b", "a"), ("a", "sep:x"), ("sep:x", None)]
    b1, b2, a, x = got
    assert x.start_ns <= a.start_ns <= b1.start_ns <= b1.end_ns \
        <= b2.start_ns <= b2.end_ns <= a.end_ns <= x.end_ns


def test_spans_accumulate_into_events():
    log = EventLog(stream=False)
    with stage("sep:x", log):
        for _ in range(3):
            with span("a"):
                pass
    ev = {e["name"]: e for e in log.events()}
    # a stage's seconds are its own add_event's, not its span's
    assert set(ev) == {"a"}
    assert ev["a"]["num_repeated"] == 3
    want = sum(s.end_ns - s.start_ns for s in log.spans() if s.name == "a")
    assert ev["a"]["val"] == pytest.approx(want * 1e-9, rel=1e-12)


def test_span_is_a_shared_noop_without_an_active_log(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock")

    monkeypatch.setattr(events.time, "time_ns", no_clock)
    assert span("a") is span("b") is events._OFF
    with span("a"):
        pass
    # a log that is not an EventLog is never active
    with stage("sep:x", object()):
        assert span("a") is events._OFF
    with stage("sep:x", None):
        assert span("a") is events._OFF
    monkeypatch.undo()
    log = EventLog(stream=False)
    with stage("sep:x", log):
        assert span("a") is not events._OFF
    # the stage leaves no active log behind
    assert span("a") is events._OFF
    assert events._ACTIVE.get() is None


class _CallLog:
    """A log with ``add_event`` alone, as the benchmark's profiled solve
    passes (``ekbench/devtrace.StampedLog``)."""

    def __init__(self):
        self.calls = []

    def add_event(self, name, val):
        self.calls.append(name)


def test_a_log_that_is_not_an_event_log_gets_the_stages_alone():
    a, _ = _pencil(N, 1)
    log = _CallLog()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        solve(a, solver="eigensx", log=log, block_size=BLOCK)
    stages = ["sep:full_to_band", "sep:band_to_tridiag", "sep:tridiag_eigh",
              "sep:back_transform"]
    assert log.calls == [x for s in stages for x in (s, f"!{s}_Gflops")]
    # under the profiler each stage is still a range, and nothing else is
    ranges = {e.name() for e in p.profiler.kineto_results.events()
              if e.is_user_annotation()}
    assert ranges == set(stages)


def test_spans_share_the_profilers_clock():
    a, _ = _pencil(N, 2)
    log = EventLog(stream=False)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        solve(a, solver="eigensx", log=log, block_size=BLOCK)
    ranges = {}
    for e in p.profiler.kineto_results.events():
        if e.is_user_annotation():
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    ms = 1_000_000
    for s in log.spans():
        # each span holds its own range, within 1 ms on either side
        assert any(s.start_ns - ms <= lo and hi <= s.end_ns + ms
                   and hi - lo >= 0 for lo, hi in ranges[s.name]), s
    assert sum(len(r) for r in ranges.values()) == len(log.spans())


def _spans_of(solver, b=None, k=None):
    a, bb = _pencil(N, 3)
    log = EventLog(stream=False)
    solve(a, bb if b else None, solver=solver, n_vec=k, log=log,
          block_size=BLOCK)
    ev = {e["name"]: e["num_repeated"] for e in log.events()}
    return log, ev


TWO_STAGE = {"to_band:panel", "to_band:update", "dc:leaves", "dc:deflate",
             "dc:secular", "dc:vectors", "wait:dc_depths", "bt:stream",
             "bt:apply", "bt:band", "wait:drain"}


@pytest.mark.parametrize("solver,b,k,names,stages", [
    ("eigensx", False, None, TWO_STAGE, 4),
    ("scalapack_select", False, 20,
     {"tridiagonalize:panel", "tridiagonalize:update", "wait:pivot_floor",
      "wait:cholesky_info", "bt:band", "wait:drain"}, 3),
    ("general_elpa2", True, None, TWO_STAGE | {"wait:cholesky_info"}, 6),
])
def test_solves_record_their_spans_and_waits(solver, b, k, names, stages):
    log, ev = _spans_of(solver, b, k)
    got = {s.name for s in log.spans()
           if not s.name.startswith(STAGE_PREFIXES)}
    assert got == names
    assert ev["wait:drain"] == stages
    parent = {s.name: s.parent for s in log.spans()}
    assert parent["wait:drain"].startswith(STAGE_PREFIXES)
    if "to_band:panel" in names:
        # a panel a bw = BLOCK columns below the band; a merge level a
        # secular solve
        assert ev["to_band:panel"] == ev["to_band:update"] \
            == -(-(N - BLOCK) // BLOCK)
        assert ev["dc:secular"] == ev["wait:dc_depths"] \
            == dc._tree_shape(N)[1]
        assert parent["to_band:panel"] == "sep:full_to_band"
        assert parent["dc:secular"] == "sep:tridiag_eigh"
        assert parent["wait:dc_depths"] == "dc:vectors"
        assert parent["bt:apply"] == parent["bt:band"] \
            == "sep:back_transform"
    else:
        assert ev["tridiagonalize:panel"] == -(-N // BLOCK)
        assert parent["tridiagonalize:update"] == "sep:tridiagonalize"
        assert parent["wait:pivot_floor"] == "sep:tridiag_eigh"


@pytest.mark.parametrize("traced", [False, True], ids=["off", "on"])
def test_back_transform_holds_one_phase_at_a_time(monkeypatch, traced):
    import weakref

    from eigenkernel_tpu_torch.ops import wf_bt

    built, live = [], []
    q_stream = wf_bt._q_stream

    def counted(*args, **kw):
        live.append(sum(r() is not None for r in built))
        P = q_stream(*args, **kw)
        built.append(weakref.ref(P))
        return P

    monkeypatch.setattr(wf_bt, "_q_stream", counted)
    monkeypatch.setattr(wf_bt, "STREAM_BYTES", 20_000)
    a, _ = _pencil(N, 4)
    solve(a, solver="eigensx", block_size=BLOCK,
          log=EventLog(stream=False) if traced else None)
    # each phase is built once the one before it is freed
    assert len(live) > 2 and live == [0] * len(live)


def test_collectives_are_spans_and_counted():
    import torch.distributed as dist

    from eigenkernel_tpu_torch.parallel import mesh as pm

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        grid = pm.single_device_mesh("cpu")
        log = EventLog(stream=False)
        x = torch.ones(4, dtype=torch.float64)
        with stage("sep:x", log):
            pm.all_reduce(x, grid)
            pm.broadcast(x, grid, 0)
        pm.all_reduce(x, grid)             # no active log: no span
    finally:
        dist.destroy_process_group()
    assert [(s.name, s.parent) for s in log.spans()] == [
        ("grid:all_reduce", "sep:x"), ("grid:broadcast", "sep:x"),
        ("sep:x", None)]
    assert (grid.stats.calls, grid.stats.bytes) == (3, 96)
    assert not hasattr(grid.stats, "seconds")


class _Ev:
    """A kineto event of PyTorch 2.11, which has no activity type: its
    ``kind`` sets only its device."""

    CPU = torch._C._autograd.DeviceType.CPU
    CUDA = torch._C._autograd.DeviceType.CUDA
    ON_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")

    def __init__(self, name, s, e, cid=0, linked=0, kind="cpu_op"):
        self._v = (name, s, e - s, cid, linked,
                   self.CUDA if kind in self.ON_DEVICE else self.CPU)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def linked_correlation_id(self):
        return self._v[4]

    def device_type(self):
        return self._v[5]


def _synthetic():
    S = events.Span
    spans = [S("to_band:panel", 120, 400, "sep:x"),
             S("to_band:update", 500, 800, "sep:x"),
             S("sep:x", 0, 1000, None)]
    ev = [
        _Ev("cudaLaunchKernel", 150, 160, cid=1, kind="cuda_runtime"),
        _Ev("dgemm", 170, 300, cid=1, kind="kernel"),
        _Ev("cudaMemcpyAsync", 450, 460, cid=3, kind="cuda_runtime"),
        _Ev("Memcpy HtoD", 455, 470, cid=3, kind="gpu_memcpy"),
        # a launch held 180 ns (a full queue), its kernel after it
        _Ev("cudaLaunchKernel", 600, 780, cid=2, kind="cuda_runtime"),
        _Ev("elementwise_kernel", 790, 850, linked=2, kind="kernel"),
        _Ev("cudaStreamSynchronize", 900, 990, cid=5, kind="cuda_runtime"),
        # launched before any span: in the window, put down to none
        _Ev("cudaLaunchKernel", -50, -40, cid=4, kind="cuda_runtime"),
        _Ev("early_kernel", -30, 50, cid=4, kind="kernel"),
        # the device's mirror of a host range, and a host operator
        _Ev("to_band:panel", 120, 400, kind="gpu_user_annotation"),
        _Ev("aten::mm", 140, 165, cid=1, kind="cpu_op"),
    ]
    return ev, spans


def test_summarize_puts_kernels_and_gaps_down_to_spans():
    ev, spans = _synthetic()
    out = summarize(ev, spans)
    assert out["window_s"] == pytest.approx(1000e-9)
    assert out["busy_s"] == pytest.approx((50 + 130 + 15 + 60) * 1e-9)
    assert (out["kernels"], out["kernels_attributed"],
            out["launches_outside"]) == (3, 2, 0)
    sp = out["spans"]
    assert sp["to_band:panel"]["kernels"] == 1
    assert sp["to_band:panel"]["device_s"] == pytest.approx(130e-9)
    assert sp["to_band:panel"]["top"] == [["dgemm", pytest.approx(130e-9)]]
    assert sp["to_band:update"]["kernels"] == 1
    assert sp["to_band:update"]["top"][0][0] == "elementwise_kernel"
    assert (sp["sep:x"]["kernels"], sp["sep:x"]["device_s"]) == \
        (0, pytest.approx(15e-9))
    assert sp["sep:x"]["host_s"] == pytest.approx(1000e-9)
    assert sp["sep:x"]["self_s"] == pytest.approx(420e-9)
    assert sp["to_band:panel"]["self_s"] == pytest.approx(280e-9)
    assert dict((k, pytest.approx(v)) for k, v in out["gaps"]) == {
        "sep:x > python": 120e-9,
        "to_band:panel > python": 155e-9,
        "to_band:update > cudaLaunchKernel": 320e-9,
        "sep:x > cudaStreamSynchronize": 150e-9}
    assert out["gaps"][0][0] == "to_band:update > cudaLaunchKernel"


def test_summarize_counts_a_launch_outside_its_span():
    ev, spans = _synthetic()
    # the launch ends after its span has closed: a clock that disagrees
    ev[4] = _Ev("cudaLaunchKernel", 600, 820, cid=2, kind="cuda_runtime")
    assert summarize(ev, spans)["launches_outside"] == 1
    assert summarize([], [])["spans"] == {}
