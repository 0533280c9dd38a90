"""The port's spans on its forecast path (``utils/profiling.py``, kept by
``weather/model.py`` and the builders it calls) and the snapshots it
stores, on the CPU at a tiny size, on the kernel backend's plain path.

Spans are kept only while a ``torch.profiler`` session records, on the
profiler's own clock, and the program adds no profiler event of its own.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import (  # noqa: E402
    ProfilerActivity, profile, record_function,
)

from njw_tpu_torch.utils import profiling  # noqa: E402
from njw_tpu_torch.weather import SimConfig, Simulation  # noqa: E402

MODELS = {
    "swe": (dict(model="shallow_water", coriolis_f=1e-4), "vortex",
            {"strength": 0.8}),
    "pe": (dict(model="primitive", num_levels=4, dx=1e5, dy=1e5, dt=240.0,
                coriolis_f=1e-4), "baroclinic", {"u_jet": 5.0}),
}
SPANS = {"sim.build": None, "sim.build.state": "sim.build",
         "sim.run": None, "sim.step": "sim.run",
         "sim.step.enqueue": "sim.step", "sim.output": "sim.run",
         "sim.output.copy": "sim.output"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sim(name: str, size: int = 24) -> Simulation:
    cfg, ic, params = MODELS[name]
    return Simulation.from_config(
        SimConfig(grid_width=size, grid_height=size, backend="kernel",
                  device="cpu", **cfg), ic, **params)


def _forecast(name: str, steps: int = 6, interval: int = 3) -> Simulation:
    sim = _sim(name)
    sim.run(steps, output_interval=interval)
    return sim


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.window"):
            out = fn()
    return out, prof


def _window(prof):
    """(start, end) ns of the test's own range, and every event's name."""
    events = list(prof.profiler.kineto_results.events())
    win = [e for e in events if e.name() == "test.window"]
    assert len(win) == 1
    start = win[0].start_ns()
    return (start, start + win[0].duration_ns()), {e.name() for e in events}


def test_no_span_is_kept_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span was kept with no profiler recording")

    monkeypatch.setattr(profiling, "_add", refuse)
    before = profiling.spans()
    for name in MODELS:
        sim = _forecast(name)
        assert len(sim.snapshots) == 2
    assert not profiling.recording()
    assert [id(s) for s in profiling.spans()] == [id(s) for s in before]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forecast_spans_nest_and_count(name):
    steps, interval = 7, 3
    sims, prof = _profiled(lambda: [_forecast(name, steps, interval)
                                    for _ in range(2)])
    ids = [sim.span_id for sim in sims]
    every = profiling.spans()
    # (a session right after another, with no port call between, adds to
    # its spans: the test's own are those of its simulations)
    spans = [s for s in every if s.sim in ids]
    assert {s.name for s in spans} == set(SPANS)
    assert all(s.end is not None and s.end >= s.start for s in spans)
    for s in spans:
        want = SPANS[s.name]
        if want is None:
            assert s.parent is None
        else:
            parent = every[s.parent]
            assert parent.name == want and parent.sim == s.sim
            assert parent.start <= s.start and s.end <= parent.end
    # one identifier a simulation, given when its build starts
    assert ids == sorted(set(ids)) and {s.sim for s in spans} == set(ids)
    assert len(spans) == 2 * (3 + 4 * 3)
    for sim in sims:
        mine = [s for s in spans if s.sim == sim.span_id]
        by = {n: [s for s in mine if s.name == n] for n in SPANS}
        assert [len(by[n]) for n in ("sim.build", "sim.build.state",
                                      "sim.run")] == [1, 1, 1]
        assert by["sim.build"][0].end <= by["sim.run"][0].start
        assert sum(s.counters["steps"] for s in by["sim.step"]) == steps
        assert sum(s.counters["steps"]
                   for s in by["sim.step.enqueue"]) == steps
        assert by["sim.run"][0].counters == {
            "steps": steps, "snapshots": len(sim.snapshots)}
        assert len(by["sim.output"]) == len(sim.snapshots) == 3
        for copy, snap in zip(by["sim.output.copy"], sim.snapshots):
            assert copy.counters["bytes"] == sum(
                v.nbytes for v in snap.values() if isinstance(v, np.ndarray))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_spans_lie_on_the_profilers_clock(name):
    """Each span lies inside the test's ``record_function`` range of the
    same profiler, and the program adds no profiler event."""
    sim, prof = _profiled(lambda: _forecast(name))
    (start, end), names = _window(prof)
    spans = [s for s in profiling.spans() if s.sim == sim.span_id]
    assert len(spans) == 3 + 4 * 2
    for s in spans:
        assert start <= s.start <= s.end <= end, s.name
    assert not {n for n in names if n.startswith("sim.")}


def test_output_span_is_the_io_time():
    sim, _ = _profiled(lambda: _forecast("swe", 8, 2))
    mine = [s for s in profiling.spans() if s.sim == sim.span_id]
    out = [s for s in mine if s.name == "sim.output"]
    assert len(out) == 4
    assert sum(s.duration_ns for s in out) / 1e6 == pytest.approx(
        sim.metrics.io_time_ms, abs=1e-4)
    steps = [s for s in mine if s.name == "sim.step"]
    assert sum(s.duration_ns for s in steps) / 1e6 == pytest.approx(
        sim.metrics.compute_time_ms, abs=1e-4)


def test_a_new_session_starts_the_spans_afresh():
    """As in a benchmark's runs: the port runs untraced between two
    profiler sessions, and the second session's spans are its own."""
    for _ in range(2):
        _forecast("pe")
        sim, _ = _profiled(lambda: _forecast("swe"))
        assert {s.sim for s in profiling.spans()} == {sim.span_id}
        assert len(profiling.spans()) == 3 + 4 * 2


@pytest.mark.parametrize("traced", [False, True])
def test_wrappers_on_the_instance_see_every_call(traced):
    sim = _sim("swe")
    calls = []

    def wrap(name, fn):
        def inner(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)

        return inner

    sim.step = wrap("step", sim.step)
    sim._store_output = wrap("output", sim._store_output)
    run = lambda: sim.run(10, output_interval=3)  # noqa: E731
    if traced:
        _profiled(run)
    else:
        run()
    assert calls == ["step", "output"] * 4
    assert sim.step_count == 10 and len(sim.snapshots) == 4


@pytest.mark.parametrize("name", sorted(MODELS))
def test_snapshots_on_the_cpu_are_their_own(name):
    """The kernel steppers ping-pong two state buffers; a snapshot of a
    CPU state is a copy, not a view of one that later steps overwrite."""
    sim = _sim(name, 64)
    sim.run(4, output_interval=1)
    snaps = sim.snapshots
    assert [s["step"] for s in snaps] == [1, 2, 3, 4]
    for a in snaps:
        for b in snaps:
            if a is not b:
                assert not any(np.shares_memory(a[k], b[k])
                               for k in a if isinstance(a[k], np.ndarray))
    again = _sim(name, 64)
    again.run(2, output_interval=2)
    for k, v in again.snapshots[0].items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(snaps[1][k], v)
            assert not np.array_equal(snaps[1][k], snaps[3][k])


@pytest.mark.parametrize("name", sorted(MODELS))
def test_output_copy_on_the_cpu_counts_no_pinned_bytes(name):
    """A CPU state's snapshot takes no pinned memory: the copy's span
    counts its bytes as before and none of them pinned."""
    sim, _ = _profiled(lambda: _forecast(name))
    copies = [s for s in profiling.spans()
              if s.sim == sim.span_id and s.name == "sim.output.copy"]
    assert len(copies) == len(sim.snapshots) == 2
    for copy, snap in zip(copies, sim.snapshots):
        assert copy.counters == {
            "bytes": sum(v.nbytes for v in snap.values()
                         if isinstance(v, np.ndarray)),
            "pinned_bytes": 0}


def _mesh_sim():
    from njw_tpu_torch.parallel import LocalMesh

    cfg, ic, params = MODELS["pe"]
    mesh = LocalMesh(2, 2, device="cpu")
    sim = Simulation.from_config(
        SimConfig(grid_width=24, grid_height=24, backend="kernel",
                  device="cpu", **cfg), ic, mesh=mesh, **params)
    mesh.exchanges = mesh.exchange_bytes = 0
    return sim, mesh


def test_exchange_spans_count_the_mesh_bytes():
    """On a mesh each halo refresh of a step is a ``sim.step.exchange``
    span inside ``sim.step.enqueue``; their ``exchange_bytes`` sum to the
    mesh's own count, and the build counts its rank."""
    def run():
        sim, mesh = _mesh_sim()
        mesh.exchanges = mesh.exchange_bytes = 0
        sim.run(3, output_interval=3)
        return sim, mesh

    (sim, mesh), _ = _profiled(run)
    every = profiling.spans()
    mine = [s for s in every if s.sim == sim.span_id]
    ex = [s for s in mine if s.name == "sim.step.exchange"]
    # four stages a step, one refresh each
    assert len(ex) == 4 * 3
    assert all(every[s.parent].name == "sim.step.enqueue" for s in ex)
    assert sum(s.counters["exchange_bytes"] for s in ex) == \
        mesh.exchange_bytes > 0
    assert sum(s.counters["exchanges"] for s in ex) == mesh.exchanges
    (build,) = [s for s in every if s.name == "sim.build"
                and s.sim == sim.span_id]
    assert build.counters == {"rank": 0}
    assert len([s for s in mine if s.name == "sim.build.state"]) == 1


@pytest.mark.parametrize("as_launches", [False, True])
def test_exchange_spans_count_their_launches(monkeypatch, as_launches):
    """Each ``sim.step.exchange`` span counts the strip-copy launches and
    collectives its refresh enqueued: on a CPU ``LocalMesh`` none (the
    plain copies, no collective); with each bound copy counted as a
    launch of the kernel, as on the card, one an axis (K5's stage on
    (2, 2): x, then y)."""
    from njw_tpu_torch.ops.halo_strips import copy_strips_cuda
    from njw_tpu_torch.parallel import halo

    monkeypatch.setattr(copy_strips_cuda, "launches",
                        copy_strips_cuda.launches)
    if as_launches:
        real = halo.bind_strips

        def launched(copy):
            def call():
                copy_strips_cuda.launches += 1
                copy()
            return call

        monkeypatch.setattr(halo, "bind_strips", lambda pairs: tuple(
            launched(c) for c in real(pairs)))

    def run():
        sim, _ = _mesh_sim()
        sim.run(2, output_interval=2)
        return sim

    sim, _ = _profiled(run)
    ex = [s for s in profiling.spans()
          if s.sim == sim.span_id and s.name == "sim.step.exchange"]
    assert len(ex) == 4 * 2
    assert [s.counters["launches"] for s in ex] == [2 * as_launches] * 8


def test_exchange_spans_only_while_a_session_records(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span was kept with no profiler recording")

    sim, mesh = _mesh_sim()
    monkeypatch.setattr(profiling, "_add", refuse)
    sim.run(2, output_interval=2)
    assert mesh.exchange_bytes > 0 and len(sim.snapshots) == 1
