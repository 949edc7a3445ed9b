"""Control flow that stays on the device: the counterparts of the
reference's `lax.cond`, its bounded `lax.while_loop` and `jax.jit`'s cache
of compiled functions, for CUDA graphs.

    cond(pred, true_fn, false_fn, operands)    lax.cond
    bounded_while(n_max, pred_fn, body_fn, carry)
                                               lax.while_loop with a
                                               static bound on its trips
    compiled(fn, cfg, state)                   fn(state, cfg) captured
                                               once as a CUDA graph

Outside a capture (every CPU tensor, and an eager step on the card) `cond`
and `bounded_while` are Python branches on a predicate read to the host
here, and nowhere else: the step's only host reads are these predicate
reads. Inside a capture that `compiled` started they read nothing: `cond`
becomes two IF nodes of the graph, on `pred` and on `~pred`, as in
torch's `if_else_node` (torch/_higher_order_ops/
cudagraph_conditional_nodes.py), and `bounded_while` becomes `n_max` IF
nodes in a row, each on the predicate the device computed just before
it. A trip after the predicate went false must be an exact no-op (the
claim rounds' are: nothing is eligible, so nothing is claimed), so the
result is the eager loop's bit for bit.

A branch returns only tensors it made or was given as `operands` (for
`bounded_while`, the carry), and both branches return the same tree of
tensors of the same shapes and dtypes. Under a capture the merged output is the true
branch's: the false branch's leaves are copied into it inside the false
body, except where the true branch returned an operand (its leaf is then
not the branch's to overwrite) or one tensor twice; those leaves are
selected after both nodes with `torch.where(pred, ...)`, which is exact.
`bounded_while`'s carry is the loop's own: under a capture each trip
writes it in place.

The IF nodes come from the kernel library (csrc/control.cu: a conditional
handle, a one-thread kernel that sets it from the predicate, the node,
and its body captured from a stream of its own), because torch 2.11's
CUDAGraph cannot capture one; it needs CUDA 12.4 or newer. While a graph
is captured every allocation of the capturing thread goes to the graph's
memory pool, the bodies' too.

`compiled` keys its cache on the function, the config, the device and
the state's shapes and dtypes, as `jax.jit` keys on static arguments and
shapes. It warms up with one eager call on a side stream, in which every
`cond` runs both branches and every `bounded_while` all its trips (so the
kernels are built, the cluster sizes chosen and every per-device constant
made before the capture), then captures one call on static input buffers
under `torch.cuda.set_sync_debug_mode("error")`, so a host read or a
host-to-device copy in the step raises at the operation that does it. A
failed capture raises; nothing falls back to the eager call. A replay
ends with the outputs copied onto the inputs inside the graph (the scan's
carry) and the call's 0-d metrics written, as int32 bits, into row `k` of
a metrics buffer, `k` a device counter: one graph launch a step.

Launch accounting. The kernels' wrappers count their launches in Python
(`counter`); inside a graph they run once, at capture. So each IF node's
body carries a one-element device counter that it adds one to when it
runs, and the capture records the wrapper launches captured in each body
(outside its nested bodies) and outside every body. When a rollout ends
the counters are read back (the rollout's one host read) and every
wrapper's count grows by replays x its launches outside the bodies plus,
for each body, the body's count x its launches in that body: the counts
the eager loop would have made. The warm-up's and the capture's own
increments are taken back.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import time

import torch

from .state import flatten

# Python counters the capture accounts for: (holder, attribute)
_COUNTERS: list = []
# device counters a captured graph holds, one an IF node body
MAX_BODIES = 256
# metric rows a graph writes before the host moves them out
METRIC_ROWS = 128
# conditional nodes nested in one another
MAX_DEPTH = 4

_WARM = False            # inside compiled()'s warm-up call
_CAPTURE = None          # the _Capture of the graph being captured


def counter(holder, attr: str = "launches"):
    """Make `holder.attr` a Python counter (set to 0) that the compiled
    rollouts keep as the eager calls would. Returns `holder`."""
    setattr(holder, attr, 0)
    _COUNTERS.append((holder, attr))
    return holder


def _snapshot():
    return [getattr(h, a) for h, a in _COUNTERS]


def _restore(values):
    for (h, a), v in zip(_COUNTERS, values):
        setattr(h, a, v)


def _capturing(t) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def _read(pred) -> bool:
    """The predicate read to the host: the only host read of an eager
    step."""
    return bool(pred)


@dataclasses.dataclass
class _Body:
    name: str
    slot: int            # its device counter
    start: list          # the Python counters when its capture began
    inner: list          # launches captured in its nested bodies
    own: list = None     # launches captured in it, outside nested bodies
    graph: int = None    # its body graph (cudaGraph_t)


class _Capture:
    """The bodies of the graph being captured and the launches in each."""

    def __init__(self, counts, streams=()):
        self.counts = counts
        self.streams = streams
        self.start = _snapshot()
        self.bodies: list = []
        self.stack: list = []
        self.inner = [0] * len(_COUNTERS)

    def open(self, name: str) -> _Body:
        if len(self.bodies) == self.counts.shape[0]:
            raise RuntimeError(f"compiled: more than {self.counts.shape[0]} "
                               "conditional bodies in one graph")
        body = _Body(name, len(self.bodies), _snapshot(),
                     [0] * len(_COUNTERS))
        self.bodies.append(body)
        self.stack.append(body)
        return body

    def close(self, body: _Body):
        self.stack.pop()
        total = [n - s for n, s in zip(_snapshot(), body.start)]
        body.own = [t - i for t, i in zip(total, body.inner)]
        outer = self.stack[-1].inner if self.stack else self.inner
        for k, t in enumerate(total):
            outer[k] += t

    def body_stream(self, depth: int):
        """The stream that captures the bodies at nesting `depth`."""
        if depth >= len(self.streams):
            raise RuntimeError(f"compiled: conditional nodes nested deeper "
                               f"than {len(self.streams)}")
        return self.streams[depth]

    def top(self) -> list:
        """Launches captured outside every body."""
        return [n - s - i for n, s, i in zip(_snapshot(), self.start,
                                              self.inner)]


@contextlib.contextmanager
def _if_body(pred, name: str):
    """Capture what runs inside into the body of an IF node on `pred` (a
    0-d bool CUDA tensor), with the body's device counter: the kernel
    library's `nudge_if_begin` adds the node to the graph the current
    stream is capturing and starts capturing its body from the stream of
    the body's nesting depth; `nudge_if_end` ends the body."""
    cap = _CAPTURE
    if cap is None:
        raise RuntimeError(f"{name}: a conditional node outside a capture "
                           "that control.compiled started")
    from . import _build

    lib = _build.library()
    pred = pred.reshape(()).to(torch.bool)
    body = cap.body_stream(len(cap.stack))
    body_graph = ctypes.c_void_p(0)
    lib.call("nudge_if_begin", pred.data_ptr(),
             torch.cuda.current_stream(pred.device).cuda_stream,
             body.cuda_stream, ctypes.byref(body_graph))
    node = cap.open(name)
    node.graph = body_graph.value
    try:
        with torch.cuda.stream(body):
            cap.counts.narrow(0, node.slot, 1).add_(1)
            yield
    finally:
        cap.close(node)
        lib.call("nudge_if_end", body.cuda_stream)


def _storages(leaves):
    return {t.untyped_storage().data_ptr() for t in leaves}


def _copy_all(dsts, srcs):
    """dst.copy_(src) for every pair, as one `_foreach_copy_` a dtype: a
    graph then holds a few multi-tensor kernels, not a copy node a
    tensor."""
    groups: dict = {}
    for d, s in zip(dsts, srcs):
        group = groups.setdefault(d.dtype, ([], []))
        group[0].append(d)
        group[1].append(s)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)


def cond(pred, true_fn, false_fn, operands=(), name: str = "cond"):
    """true_fn(*operands) if pred else false_fn(*operands), `pred` a 0-d
    bool tensor: a Python branch outside a capture, two IF nodes inside
    one (see the module docstring)."""
    if _WARM:
        t_out = true_fn(*operands)
        f_out = false_fn(*operands)
        return t_out if _read(pred) else f_out
    if not _capturing(pred):
        return true_fn(*operands) if _read(pred) else false_fn(*operands)

    pred = pred.reshape(()).to(torch.bool)
    taken = _storages(flatten(operands)[0])
    with _if_body(pred, name + ":true"):
        t_out = true_fn(*operands)
    t_leaves, build = flatten(t_out)
    ids = [id(t) for t in t_leaves]
    owned = [t.untyped_storage().data_ptr() not in taken
             and ids.count(id(t)) == 1 for t in t_leaves]
    select, dsts, srcs = [], [], []
    with _if_body(torch.logical_not(pred), name + ":false"):
        f_leaves, _ = flatten(false_fn(*operands))
        if len(f_leaves) != len(t_leaves):
            raise ValueError(f"cond {name}: the branches return different "
                             "trees")
        for k, (t, f) in enumerate(zip(t_leaves, f_leaves)):
            if t.shape != f.shape or t.dtype != f.dtype:
                raise ValueError(
                    f"cond {name}: leaf {k} is {t.dtype} {tuple(t.shape)} "
                    f"in one branch, {f.dtype} {tuple(f.shape)} in the other")
            if t is f:
                continue
            if owned[k]:
                dsts.append(t)
                srcs.append(f)
            else:
                select.append(k)
        _copy_all(dsts, srcs)
    out = list(t_leaves)
    for k in select:
        out[k] = torch.where(pred, t_leaves[k], f_leaves[k])
    return build(out)


def bounded_while(n_max: int, pred_fn, body_fn, carry, name: str = "while"):
    """while c < n_max and pred_fn(c, carry): carry = body_fn(c, carry);
    c += 1. `pred_fn` returns a 0-d bool tensor; `c` is static in each
    trip. Outside a capture the loop stops at the first false predicate;
    inside one every trip is an IF node on its predicate, whose body writes
    the carry in place."""
    for c in range(n_max):
        p = pred_fn(c, carry)
        if _WARM:
            new = body_fn(c, carry)
            if _read(p):
                carry = new
            continue
        if _capturing(p):
            leaves = flatten(carry)[0]
            with _if_body(p, f"{name}:{c}"):
                new = flatten(body_fn(c, carry))[0]
                changed = [k for k, n in enumerate(new) if n is not leaves[k]]
                _copy_all([leaves[k] for k in changed],
                          [new[k] for k in changed])
            continue
        if not _read(p):
            break
        carry = body_fn(c, carry)
    return carry


_CONSTANTS: dict = {}


def constant(values, dtype, device) -> torch.Tensor:
    """`torch.tensor(values)` on `device`, made once per device and value
    (a copy from the host cannot be captured; the warm-up makes each
    constant before the capture reads it)."""
    key = (repr(values), dtype, str(torch.device(device)))
    t = _CONSTANTS.get(key)
    if t is None:
        t = torch.tensor(values, dtype=dtype, device=device)
        _CONSTANTS[key] = t
    return t


def _pack(metrics):
    """The 0-d leaves of `metrics` as one i32 row of their bits."""
    cols = []
    for t in flatten(metrics)[0]:
        if t.dtype == torch.float32:
            t = t.view(torch.int32)
        cols.append(t.to(torch.int32).reshape(()))
    return torch.stack(cols)


def _unpack(rows, metrics):
    """The tree of `metrics` with [n] leaves from i32 rows [n, leaves]."""
    leaves, build = flatten(metrics)
    out = []
    for k, t in enumerate(leaves):
        col = rows[:, k].contiguous()
        if t.dtype == torch.float32:
            col = col.view(torch.float32)
        elif t.dtype == torch.bool:
            col = col != 0
        else:
            col = col.to(t.dtype)
        out.append(col)
    return build(out)


@contextlib.contextmanager
def _sync_debug_error():
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


class Compiled:
    """fn(state, cfg) -> (state, metrics of 0-d tensors) captured once as
    a CUDA graph on static input buffers. `rollout` replays it."""

    def __init__(self, fn, cfg, state):
        global _WARM, _CAPTURE
        leaves, self._build = flatten(state)
        dev = leaves[0].device
        self.inputs = [torch.empty(t.shape, dtype=t.dtype, device=dev)
                       for t in leaves]
        torch._foreach_copy_(self.inputs, leaves)
        self.counts = torch.zeros(MAX_BODIES, dtype=torch.int64, device=dev)
        self.row = torch.zeros(1, dtype=torch.int64, device=dev)
        saved = _snapshot()

        # warm-up: every branch and trip once, on the capture's stream
        streams = _streams(dev)
        side = streams[0]
        side.wait_stream(torch.cuda.current_stream(dev))
        _WARM = True
        try:
            with torch.cuda.stream(side):
                _, m = fn(self._build(self.inputs), cfg)
                n_metrics = len(flatten(m)[0])
        finally:
            _WARM = False
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self.rows = torch.zeros((METRIC_ROWS, n_metrics), dtype=torch.int32,
                                device=dev)

        start = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        pool = torch.cuda.graph_pool_handle()
        cap = _CAPTURE = _Capture(self.counts, streams[1:])
        routed = False
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=side), \
                    _sync_debug_error():
                # the bodies' streams allocate from the graph's pool as
                # well: every allocation of this thread goes there
                torch._C._cuda_endAllocateToPool(dev.index, pool)
                torch._C._cuda_beginAllocateCurrentThreadToPool(dev.index,
                                                                pool)
                routed = True
                out, metrics = fn(self._build(self.inputs), cfg)
                outs = flatten(out)[0]
                if len(outs) != len(self.inputs):
                    raise ValueError("compiled: the state's tree changed")
                mine = _storages(self.inputs)
                carry_dst, carry_src = [], []
                for i, o in zip(self.inputs, outs):
                    if o is i:
                        continue
                    if o.untyped_storage().data_ptr() in mine:
                        o = o.clone()         # a view of an input
                    carry_dst.append(i)
                    carry_src.append(o)
                _copy_all(carry_dst, carry_src)
                self.rows.index_copy_(0, self.row, _pack(metrics)[None])
                self.row.add_(1)
            self.top = cap.top()
        finally:
            _CAPTURE = None
            _restore(saved)
            if routed:      # beginAllocate took a reference on the pool
                torch._C._cuda_releasePool(dev.index, pool)
        self.graph.instantiate()
        self.bodies = cap.bodies
        self._metrics = metrics
        self.capture_s = time.perf_counter() - start

    # --- a rollout: start, then load / replay / store per state, finish ---
    def start(self):
        self.counts.zero_()
        self.replays = 0

    def load(self, state):
        torch._foreach_copy_(self.inputs, flatten(state)[0])

    def replay(self, steps: int):
        """`steps` replays; the metrics as a tree of [steps] tensors."""
        out = torch.empty((steps, self.rows.shape[1]), dtype=torch.int32,
                          device=self.rows.device)
        done = 0
        while done < steps:
            n = min(METRIC_ROWS, steps - done)
            self.row.zero_()
            for _ in range(n):
                self.graph.replay()
            out[done:done + n].copy_(self.rows[:n])
            done += n
        self.replays += steps
        return _unpack(out, self._metrics)

    def state(self):
        """A state cloned out of the static buffers."""
        return self._build([t.clone() for t in self.inputs])

    def store(self, dst_leaves):
        torch._foreach_copy_(dst_leaves, self.inputs)

    def finish(self) -> dict:
        """Read the body counters back (one host read) and add the
        rollout's launches to the Python counters. Returns {body name:
        times it ran}."""
        counts = self.counts_read = self.counts[:len(self.bodies)].tolist()
        total = [self.replays * n for n in self.top]
        for body, c in zip(self.bodies, counts):
            for k, n in enumerate(body.own):
                total[k] += c * n
        for (h, a), n in zip(_COUNTERS, total):
            if n:
                setattr(h, a, getattr(h, a) + n)
        ran = {}
        for body, c in zip(self.bodies, counts):
            ran[body.name] = ran.get(body.name, 0) + c
        self.ran = ran
        return ran

    def rollout(self, state, steps: int):
        """(state after `steps` replays, metrics with [steps] leaves)."""
        self.start()
        self.load(state)
        metrics = self.replay(steps)
        out = self.state()
        self.finish()
        return out, metrics


_STREAMS: dict = {}


def _streams(device) -> list:
    """The capture's stream and one stream a nesting depth of IF bodies,
    made once per device and together: torch hands out streams from a
    round-robin pool of 32, so streams taken one at a time over many
    captures would come round to one another."""
    key = str(device)
    if key not in _STREAMS:
        _STREAMS[key] = [torch.cuda.Stream(device)
                         for _ in range(1 + MAX_DEPTH)]
    return _STREAMS[key]


_CACHE: dict = {}


def compiled(fn, cfg, state) -> Compiled:
    """The graph of fn(state, cfg) for this config, device and state shape,
    captured at the first call."""
    leaves = flatten(state)[0]
    key = (fn, cfg, str(leaves[0].device),
           tuple((tuple(t.shape), t.dtype) for t in leaves))
    got = _CACHE.get(key)
    if got is None:
        got = _CACHE[key] = Compiled(fn, cfg, state)
    return got


def clear():
    """Drop every cached graph and its memory pool."""
    _CACHE.clear()
