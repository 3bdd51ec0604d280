"""The port's tracing: spans and counters, kept in memory, and the block
timers built on them. Counterpart of ``psdr_tpu/profiling.py``.

* ``span(name)``, a context manager and a decorator, times a block on the
  host clock (``time.perf_counter_ns``). Spans nest: each knows the span
  that encloses it on its thread. Completed spans aggregate by name into
  a count, a total and a maximum (``spans()``), so a long-running process
  keeps a bounded store; ``recording()`` keeps every span of a block as
  well (``Span``), whose ``self_times`` are each name's time less the time
  of the spans directly inside it. While a ``torch.profiler`` session is
  active, a span also opens a ``record_function`` of its name, so the
  profiler's trace shows the device's kernels under the program's own
  layers, on the device's clock. Otherwise a span costs a flag check and
  two clock reads.
* ``count(name, n)`` adds to a counter, ``counters()`` reads them all.
  ``CounterGroup`` is a fixed set of counters read as a dict: the kernel
  launches of ``accel.intersect.LAUNCHES`` are the group ``launches``,
  and ``accel.intersect.RNG_LAUNCHES`` its counter ``launches.rng``.
  A captured program takes back what its capture counted and adds it on
  every replay (``program.py``), so a counter means the same eager or
  replayed.
* ``timed`` is a span that prints its wall time (``.block(x)`` on the
  yielded handle waits for the card's work first, so the time includes
  it), ``trace`` records a ``torch.profiler`` trace of a block into a
  directory (Chrome trace format: open it in ui.perfetto.dev),
  ``render_timed`` is renderC with the timing print that ``log_level``
  turns on.

The spans of the forward path, one name a layer: ``render`` (the root,
``Integrator.render_fn`` and the program cache's bodies), ``camera``,
``rng``, ``intersect``, ``bsdf``, ``emitter``, ``film``; ``path.bounce``
around each depth of ``PathTracer.Li`` after the camera's (its shading
arithmetic, the layers it calls inside it); around them
``program.warm_up``, ``program.capture``, ``program.call``,
``scene.prepare_accel``, ``scene.build``, ``accel.load_library`` and
``envmap.tables``. ``open_spans()`` names the spans open on the calling
thread. The counters: ``launches.<kernel>``, ``k1.rays`` (the lanes
launched into K1), ``k1.rays.bounce`` (those of them launched inside
``path.bounce``), ``path.bounces`` (the depths run after the camera's),
``program.captures.first``, ``program.captures.retrace`` (graphs
captured again after ``retrace_on`` changed) and ``program.replays``.
``Program.profile_layers`` times the layers' spans on the device inside
a captured graph.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time
from collections.abc import MutableMapping
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler


class Span(NamedTuple):
    """A completed span: its ``name``, its ``id``, the id of the span that
    enclosed it (-1 at a root) and its host-clock ends in nanoseconds."""
    name: str
    id: int
    parent: int
    start_ns: int
    end_ns: int


_STATS: dict = {}      # name -> [count, total ns, max ns]
_COUNTS: dict = {}     # counter name -> value
_LOCAL = threading.local()
_IDS = itertools.count()
_recorded: list | None = None
# f(name, entering) at each span boundary, set by ``boundaries``
_hook = None


def _stack() -> list:
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


def open_spans() -> tuple:
    """The names of the spans open on the calling thread, outermost
    first."""
    return tuple(f.name for f in _stack())


class _Frame:
    """An open span; ``elapsed`` (seconds) once it has ended."""
    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "rf")

    @property
    def elapsed(self) -> float | None:
        if self.end_ns is None:
            return None
        return (self.end_ns - self.start_ns) * 1e-9


class span:
    """A span named ``name`` around a block (``with span(name) as f``; the
    frame's ``elapsed`` is its seconds once it ends) or around every call
    of a function (``@span(name)``)."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> _Frame:
        st = _stack()
        f = _Frame()
        f.name = self.name
        f.id = next(_IDS)
        f.parent = st[-1].id if st else -1
        f.end_ns = None
        f.rf = None
        if _autograd_profiler._is_profiler_enabled:
            f.rf = torch.profiler.record_function(self.name)
            f.rf.__enter__()
        if _hook is not None:
            _hook(self.name, True)
        st.append(f)
        f.start_ns = time.perf_counter_ns()
        return f

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        f = _stack().pop()
        f.end_ns = end
        if _hook is not None:
            _hook(f.name, False)
        if f.rf is not None:
            f.rf.__exit__(None, None, None)
        d = end - f.start_ns
        s = _STATS.get(f.name)
        if s is None:
            _STATS[f.name] = [1, d, d]
        else:
            s[0] += 1
            s[1] += d
            if d > s[2]:
                s[2] = d
        if _recorded is not None:
            _recorded.append(Span(f.name, f.id, f.parent, f.start_ns, end))
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return spanned


@contextlib.contextmanager
def recording():
    """Keep every span that ends inside the block: yields the list of
    ``Span``s, filled in the order they end."""
    global _recorded
    outer, _recorded = _recorded, []
    kept = _recorded
    try:
        yield kept
    finally:
        if outer is not None:
            outer.extend(kept)
        _recorded = outer


@contextlib.contextmanager
def boundaries(fn):
    """Call ``fn(name, entering)`` at each span boundary inside the block,
    as the span opens and as it closes (``Program.profile_layers`` takes a
    device timestamp there)."""
    global _hook
    outer, _hook = _hook, fn
    try:
        yield
    finally:
        _hook = outer


def self_times(recorded) -> dict:
    """Each name's self time in seconds over ``recorded`` ``Span``s: the
    time of its spans less the time of the spans directly inside them."""
    by_id = {s.id: s for s in recorded}
    out: dict = {}
    for s in recorded:
        d = s.end_ns - s.start_ns
        out[s.name] = out.get(s.name, 0) + d
        parent = by_id.get(s.parent)
        if parent is not None:
            out[parent.name] = out.get(parent.name, 0) - d
    return {k: v * 1e-9 for k, v in out.items()}


def spans() -> dict:
    """The completed spans by name: ``{name: {"count", "total_s",
    "max_s"}}``."""
    return {k: {"count": c, "total_s": t * 1e-9, "max_s": m * 1e-9}
            for k, (c, t, m) in _STATS.items()}


# -- counters ---------------------------------------------------------------
def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> dict:
    """Every counter's value, by name."""
    return dict(_COUNTS)


def take_back(before: dict) -> dict:
    """The counts added since ``before`` (a ``counters()``), taken back:
    what a capture counted, which its program adds on every replay."""
    added = {k: v - before.get(k, 0) for k, v in _COUNTS.items()
             if v != before.get(k, 0)}
    _COUNTS.clear()
    _COUNTS.update(before)
    return added


class CounterGroup(MutableMapping):
    """The counters ``<prefix>.<key>`` of a fixed set of keys, read and
    written as a dict of the keys."""

    def __init__(self, prefix: str, keys):
        self._names = {k: f"{prefix}.{k}" for k in keys}
        for name in self._names.values():
            _COUNTS.setdefault(name, 0)

    def __getitem__(self, key):
        return _COUNTS.get(self._names[key], 0)

    def __setitem__(self, key, value):
        _COUNTS[self._names[key]] = value

    def __delitem__(self, key):
        raise TypeError("a counter group's keys are fixed")

    def __iter__(self):
        return iter(self._names)

    def __len__(self):
        return len(self._names)

    def __repr__(self):
        return repr(dict(self))


def snapshot() -> dict:
    """The store as it stands: ``{"spans": spans(), "counters":
    counters()}``."""
    return {"spans": spans(), "counters": counters()}


# -- block timers -----------------------------------------------------------
def _synchronize(x) -> None:
    """Wait for the card if any tensor in ``x`` (a tensor or a nest of
    dicts, lists and tuples) lies on it."""
    stack = [x]
    while stack:
        y = stack.pop()
        if isinstance(y, torch.Tensor):
            if y.is_cuda:
                torch.cuda.synchronize(y.device)
                return
        elif isinstance(y, dict):
            stack.extend(y.values())
        elif isinstance(y, (list, tuple)):
            stack.extend(y)


class _Handle:
    elapsed = None

    @staticmethod
    def block(x):
        _synchronize(x)
        return x


@contextlib.contextmanager
def timed(label: str, result_holder: dict | None = None, log: bool = True):
    """A span named ``label`` that prints its wall time;
    ``handle.block(x)`` returns ``x`` once the device work that produces
    it is done."""
    h = _Handle()
    try:
        with span(label) as f:
            yield h
    finally:
        h.elapsed = f.elapsed
        if result_holder is not None:
            result_holder[label] = h.elapsed
        if log:
            print(f"[psdr_tpu_torch] {label}: {h.elapsed * 1e3:.1f} ms",
                  flush=True)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the block (host, the spans, and the
    card's kernels where there is one), written to
    ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def render_timed(integrator, scene, sensor_id: int = 0, seed: int = 0):
    """renderC with a timing print when ``scene.opts.log_level > 0`` ->
    (image, seconds)."""
    holder: dict = {}
    with timed("renderC", holder, log=scene.opts.log_level > 0) as h:
        img = h.block(integrator.renderC(scene, sensor_id, seed))
    return img, holder["renderC"]
