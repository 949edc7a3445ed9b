"""Tracing of the port: stage stamps inside the captured step, live counts
of the step's work, and host spans of each call, on one clock. Off by
default.

    with trace.on(): ...      tracing on inside the block
    trace.enabled()           whether it is on
    trace.span(name)          a host span (a context manager)
    trace.stage(name)         the boundary at which stage `name` ends
    trace.count(**values)     0-d device counts of the step's work
    trace.collect()           the spans and replays recorded so far,
                              taken out of memory

With tracing off each of `span`, `stage` and `count` is one global check,
and `control.compiled` and `control.compiled_grad` capture the graphs they
capture without it, node for node. Both add the tracing state to their
cache key, so a graph captured with tracing on is a capture of its own,
with a `Recorder`: rows of int64, one a replay (the row is the graph's
device counter), into which

- `stage(name)` adds one node, a one-thread kernel (`nudge_stamp`,
  csrc/control.cu) that writes the card's `%globaltimer` (ns) into the
  stage's slot. A captured step records from one stream, so its nodes form
  a chain and the stamps at its boundaries bracket each stage exactly. The
  graph's first stamp (`start`) also sets every slot of its row to -1 (a
  stamp or count in a conditional body that did not run keeps it), and
  its last one ends the replay: the stages tile it.
- `count(name=value)` copies the value into the count's slot.

The owner moves the rows out beside its metrics rows as it replays, and
its `finish`, which reads its body counters back, reads them to the host
with them and converts the stamps to the host clock: the offset is
calibrated there from one stamp between two host clock reads around a
synchronize (after one untimed stamp, the tightest of three), and half
that round trip is its error bound (`Replay`).

Outside a capture, with tracing on, `span` records a host span on
`time.perf_counter_ns()`: name, start, end, the id of the span it opened
inside (`parent`) and the id every span of one top-level call shares
(`call`), entered as a `torch.profiler.record_function` range too, so a
profiled run shows the program's spans on its timeline. `stage` records,
inside the innermost open span (an eager `engine.step`'s `step`), a child
span from the previous boundary (or the span's start) to now, and `count`
keeps its values, on the device, on that span. During a traced capture
neither records anything on the host. Everything stays in memory until
`collect`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time

import torch

_ON = False
_REC = None              # the Recorder of the traced graph being captured
_OPEN: list = []         # open host spans, innermost last
_SPANS: list = []        # finished host spans
_REPLAYS: list = []      # replays of traced graphs, read back
_IDS = itertools.count(1)
_NULL = contextlib.nullcontext()
UNSET = -1               # a slot no stamp or count wrote in its replay
SLOTS = 32               # slots a traced graph's row holds


@contextlib.contextmanager
def on():
    """Tracing on inside the block (and as it was after it)."""
    global _ON
    was, _ON = _ON, True
    try:
        yield
    finally:
        _ON = was


def enabled() -> bool:
    return _ON


@dataclasses.dataclass
class Span:
    """A host span: times in ns of `time.perf_counter_ns()`; `counts`
    holds the live counts an eager step recorded inside it."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    call: int
    counts: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Replay:
    """One replay of a traced graph: its stamps in the order its nodes ran,
    [(stage that ends there, host-clock ns or None where unset)], its
    counts {name: value or None}, the span open when its row was moved
    out (`parent`, `call`), and the clock offset's error bound in ns."""

    graph: str
    stamps: list
    counts: dict
    parent: int | None
    call: int | None
    error_ns: int


class _Open:
    """An open host span."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        outer = _OPEN[-1] if _OPEN else None
        self.id = next(_IDS)
        self.parent = outer.id if outer else None
        self.call = outer.call if outer else self.id
        self.counts = {}
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        _OPEN.append(self)
        self.start = self.mark = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _OPEN.remove(self)
        self.range.__exit__(*exc)
        _SPANS.append(Span(self.name, self.start, end, self.id, self.parent,
                           self.call, self.counts))


def span(name: str):
    """A host span around the block (nothing with tracing off or inside a
    traced capture)."""
    if not _ON or _REC is not None:
        return _NULL
    return _Open(name)


def stage(name: str):
    """The boundary at which stage `name` ends: a stamp node in a traced
    capture, a host span in an eager step with tracing on."""
    if not _ON:
        return
    if _REC is not None:
        _REC.stamp(name)
    elif _OPEN:
        outer, now = _OPEN[-1], time.perf_counter_ns()
        _SPANS.append(Span(name, outer.mark, now, next(_IDS), outer.id,
                           outer.call))
        outer.mark = now


def count(**values):
    """Live counts of the step's work (0-d device tensors): written into
    the replay's row in a traced capture, kept on the innermost open span
    in an eager step. The caller computes them only when `enabled()`."""
    if not _ON:
        return
    if _REC is not None:
        for name, value in values.items():
            _REC.put(name, value)
    elif _OPEN:
        _OPEN[-1].counts.update({k: v.detach() for k, v in values.items()})


@dataclasses.dataclass
class Trace:
    spans: list
    replays: list


def collect() -> Trace:
    """The spans and replays recorded since the last `collect` (counts
    read to the host), taken out of memory."""
    spans, replays = list(_SPANS), list(_REPLAYS)
    _SPANS.clear()
    _REPLAYS.clear()
    for s in spans:
        s.counts = {k: int(v) for k, v in s.counts.items()}
    return Trace(spans, replays)


def _current():
    return (_OPEN[-1].id, _OPEN[-1].call) if _OPEN else (None, None)


def _stamp(rows, row, row_offset: int, slot: int, clear: int):
    """Launch the stamp kernel on the current stream: rows[row[0] +
    row_offset, slot] = %globaltimer, after slots [0, clear) of that row
    are set to UNSET (`row` None: row 0)."""
    from . import _build

    _build.library().call(
        "nudge_stamp", rows.data_ptr(), 0 if row is None else row.data_ptr(),
        row_offset, rows.shape[1], slot, clear,
        torch.cuda.current_stream(rows.device).cuda_stream)


@contextlib.contextmanager
def recording(rec):
    """Inside a capture: `stage` and `count` write into `rec` (None: a
    graph captured without tracing)."""
    global _REC
    if rec is None:
        yield
        return
    _REC = rec
    try:
        yield
    finally:
        _REC = None


_CLOCK: dict = {}


def calibrate(device, tries: int = 3):
    """(offset, error) in ns: host-clock ns = device stamp + offset, from
    one stamp between two host clock reads around a synchronize; the error
    bound is half that round trip. One untimed stamp goes first (the first
    after the card idles returns late), then the tightest of `tries` is
    kept."""
    key = str(device)
    if key not in _CLOCK:
        _CLOCK[key] = torch.zeros((1, 1), dtype=torch.int64, device=device)
    buf = _CLOCK[key]
    best = None
    _stamp(buf, None, 0, 0, 0)
    torch.cuda.synchronize(device)
    for _ in range(tries):
        t0 = time.perf_counter_ns()
        _stamp(buf, None, 0, 0, 0)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter_ns()
        got = ((t0 + t1) // 2 - int(buf[0, 0]), (t1 - t0) // 2)
        if best is None or got[1] < best[1]:
            best = got
    return best


class Recorder:
    """The trace rows of one traced graph (`graph` names it): [rows,
    SLOTS] int64 on the device, the row a replay writes given by the
    device counter `row`, and what each slot holds (`names`, `kinds`).
    Its owner calls `next` before each replay and `keep` where it starts
    its rows again; `flush` reads what was kept."""

    def __init__(self, graph: str, n_rows: int, row):
        self.graph = graph
        self.row = row
        self.rows = torch.full((n_rows, SLOTS), UNSET, dtype=torch.int64,
                               device=row.device)
        self.names, self.kinds = [], []
        self.kept = []
        self.used = 0            # rows written since the last `keep`

    def _slot(self, name: str, kind: str) -> int:
        if len(self.names) == SLOTS:
            raise RuntimeError(f"trace: more than {SLOTS} stamps and counts "
                               "in one graph")
        self.names.append(name)
        self.kinds.append(kind)
        return len(self.names) - 1

    def begin(self):
        """The replay's first stamp: clears its row first."""
        _stamp(self.rows, self.row, 0, self._slot("start", "stamp"), SLOTS)

    def stamp(self, name: str, row_offset: int = 0):
        _stamp(self.rows, self.row, row_offset, self._slot(name, "stamp"), 0)

    def put(self, name: str, value):
        col = self.rows.narrow(1, self._slot(name, "count"), 1)
        col.index_copy_(0, self.row, value.reshape(1, 1).to(torch.int64))

    def next(self):
        """Before a replay: the rows kept first when every one is used."""
        if self.used == self.rows.shape[0]:
            self.keep()
        self.used += 1

    def keep(self):
        """Move the rows written since the last `keep` out (on the device),
        under the open span, and start the rows again (the row counter
        zeroed)."""
        if self.used:
            self.kept.append((self.rows[:self.used].clone(), *_current()))
            self.row.zero_()
            self.used = 0

    def flush(self):
        """Keep what is left, read the rows kept to the host, convert their
        stamps to the host clock and add them to the replays `collect`
        returns."""
        self.keep()
        if not self.kept:
            return
        host = torch.cat([r for r, _, _ in self.kept]).tolist()
        offset, err = calibrate(self.rows.device)
        at = 0
        for rows, parent, call in self.kept:
            for vals in host[at:at + rows.shape[0]]:
                stamps, counts = [], {}
                for name, kind, v in zip(self.names, self.kinds, vals):
                    if kind == "stamp":
                        stamps.append((name, None if v == UNSET
                                       else v + offset))
                    else:
                        counts[name] = None if v == UNSET else v
                _REPLAYS.append(Replay(self.graph, stamps, counts, parent,
                                       call, err))
            at += rows.shape[0]
        self.kept = []
