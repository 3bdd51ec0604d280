"""The port's tracing on the CPU (``psdr_tpu_torch/profiling.py``): the
span tree and self times, the spans of a render in a ``torch.profiler``
trace, the cost of a span with no profiler, the one counter store that
``accel.intersect.LAUNCHES`` is part of, what a program counts a call,
and ``Program.profile_layers``' refusal of CPU tensors."""
import json

import pytest
import torch

from psdr_tpu_torch import DirectIntegrator, profiling
from psdr_tpu_torch.accel import intersect
from psdr_tpu_torch.convert import params_from_numpy
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.program import Program
from psdr_tpu_torch.testing.scenes import sphere_light_scene

LAYERS = ("camera", "rng", "intersect", "bsdf", "emitter", "film")


def test_self_times_of_hand_built_spans():
    """A span's self time is its time less that of the spans directly
    inside it; spans of one name add up."""
    S = profiling.Span
    ms = 1_000_000
    spans = [S("rng", 2, 1, 1 * ms, 3 * ms),       # inside camera
             S("camera", 1, 0, 0, 4 * ms),         # inside render
             S("rng", 3, 0, 5 * ms, 6 * ms),       # inside render
             S("render", 0, -1, 0, 10 * ms)]
    got = profiling.self_times(spans)
    want = {"render": 5e-3, "camera": 2e-3, "rng": 3e-3}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12)
    assert sum(got.values()) == pytest.approx(10e-3)


@pytest.mark.parametrize("form", ["block", "decorator"])
def test_spans_nest_and_aggregate(form):
    """Each span records the span around it; recursion through one
    decorated function nests its own spans; the store keeps count, total
    and maximum by name, and ``recording`` every span, in the order they
    end."""
    inner = profiling.span("t.inner")
    name = f"t.outer.{form}"          # the store is the process's

    @profiling.span(name)
    def outer(depth):
        if depth:
            return outer(depth - 1)
        if form == "block":
            with inner:
                pass
        else:
            inner(lambda: None)()

    with profiling.recording() as rec:
        outer(2)
    assert [s.name for s in rec] == ["t.inner", name, name, name]
    by_id = {s.id: s for s in rec}
    assert by_id[rec[0].parent].name == name
    assert rec[1].parent == rec[2].id and rec[2].parent == rec[3].id
    assert rec[3].parent not in by_id
    for s in rec:
        assert s.end_ns >= s.start_ns
    agg = profiling.spans()[name]
    assert agg["count"] == 3
    assert agg["max_s"] <= agg["total_s"]
    assert agg["max_s"] == pytest.approx(
        (rec[3].end_ns - rec[3].start_ns) * 1e-9)
    times = profiling.self_times(rec)
    assert times[name] + times["t.inner"] == pytest.approx(
        (rec[3].end_ns - rec[3].start_ns) * 1e-9)


def test_timed_is_a_span_and_keeps_its_print(capsys):
    holder = {}
    before = profiling.spans().get("t.timed", {"count": 0})["count"]
    with profiling.timed("t.timed", holder):
        pass
    assert profiling.spans()["t.timed"]["count"] == before + 1
    assert holder["t.timed"] > 0
    assert "[psdr_tpu_torch] t.timed:" in capsys.readouterr().out


def test_render_trace_holds_the_layers(tmp_path):
    """A 16x16 render on the CPU under ``profiling.trace``: the Chrome
    trace holds a span of every layer, on the profiler's clock; in the
    span tree ``rng`` sits inside ``camera``, and every layer inside
    ``render``."""
    sc = sphere_light_scene(16, 16, spp=2, device="cpu")
    with profiling.recording() as rec, profiling.trace(str(tmp_path)):
        img = DirectIntegrator(1, 1).renderC(sc, seed=0)
    assert img.shape == (16, 16, 3) and float(img.mean()) > 0
    events = json.loads((tmp_path / "trace.json").read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    traced = {e.get("name") for e in events}
    for name in LAYERS + ("render", "program.call"):
        assert name in traced, name
    by_id = {s.id: s for s in rec}

    def ancestors(s):
        while s.parent in by_id:
            s = by_id[s.parent]
            yield s.name
    assert any("camera" in ancestors(s) for s in rec if s.name == "rng")
    for s in rec:
        if s.name in LAYERS:
            assert "render" in ancestors(s), s.name


def test_no_record_function_without_a_profiler(monkeypatch):
    """With no profiler active a span never builds a ``record_function``:
    a render runs with it made to raise."""
    def refuse(*a, **k):
        raise AssertionError("record_function built with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    sc = sphere_light_scene(8, 8, spp=1, device="cpu")
    with profiling.recording() as rec:
        DirectIntegrator(1, 1).renderC(sc, seed=0)
    assert {s.name for s in rec} >= set(LAYERS)


def test_launches_are_counters_of_the_one_store():
    """``LAUNCHES`` reads and writes the counters ``launches.<kernel>``;
    ``reset_launch_counts`` zeroes them, and its keys never change."""
    intersect.reset_launch_counts()
    intersect.LAUNCHES["k2"] += 2
    intersect.LAUNCHES["any"] += 1
    assert profiling.counters()["launches.k2"] == 2
    assert profiling.counters()["launches.any"] == 1
    assert intersect.LAUNCHES == {"closest": 0, "any": 1, "k2": 2, "k3": 0,
                                  "segsum": 0}
    assert list(dict(intersect.LAUNCHES)) == ["closest", "any", "k2", "k3",
                                              "segsum"]
    with pytest.raises(KeyError):
        intersect.LAUNCHES["k9"] += 1
    with pytest.raises(TypeError):
        del intersect.LAUNCHES["k2"]
    intersect.reset_launch_counts()
    assert set(intersect.LAUNCHES.values()) == {0}


def test_take_back_returns_and_restores_a_capture_counts():
    """What a capture counted comes back as its program's per-replay
    counts, and the store is as before it."""
    before = profiling.counters()
    profiling.count("t.captured", 3)
    intersect.LAUNCHES["closest"] += 2
    added = profiling.take_back(before)
    assert added == {"t.captured": 3, "launches.closest": 2}
    assert profiling.counters() == before
    for _ in range(2):                    # two replays
        for k, v in added.items():
            profiling.count(k, v)
    assert profiling.counters()["t.captured"] == before.get(
        "t.captured", 0) + 6


def test_a_counter_in_a_program_body_counts_once_a_call():
    """A counter bumped inside a program's body counts once a call, and
    each call is one ``program.call`` span."""
    def body(x):
        profiling.count("t.body")
        return x * 2

    prog = Program(body, name="t.prog")
    c0 = profiling.counters().get("t.body", 0)
    with profiling.recording() as rec:
        for _ in range(3):
            prog(torch.ones(4))
    assert profiling.counters()["t.body"] == c0 + 3
    assert [s.name for s in rec] == ["program.call"] * 3


def test_profile_layers_raises_on_the_cpu():
    sc = sphere_light_scene(8, 8, spp=1, device="cpu")
    integ = DirectIntegrator(1, 1)
    prog = integ.render_program(sc)
    p = params_from_numpy(sc.params(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        prog.profile_layers(p, threefry.PRNGKey(0))


def test_profile_layers_stamp_builds_with_the_library():
    """``profile_layers``' timestamp kernel (``csrc/stamp.cu``) is one of
    the library's sources: a one-thread kernel that writes the device's
    nanosecond clock into a slot, behind a C launcher."""
    src = intersect._CSRC / "stamp.cu"
    assert src in intersect._SOURCES and src.is_file()
    text = src.read_text()
    assert 'extern "C" int psdr_stamp(int64_t* slots, int slot,' in text
    assert "%%globaltimer" in text and "<<<1, 1, 0," in text
