"""Control flow that stays on the device: the counterparts of the
reference's `lax.cond`, its bounded `lax.while_loop` and `jax.jit`'s cache
of compiled functions, for CUDA graphs.

    cond(pred, true_fn, false_fn, operands)    lax.cond
    bounded_while(n_max, pred_fn, body_fn, carry)
                                               lax.while_loop with a
                                               static bound on its trips,
                                               eager only
    compiled(fn, cfg, state)                   fn(state, cfg) captured
                                               once as a CUDA graph
    compiled_grad(fn, cfg, state, need)        the backward of one step of
                                               fn, captured once a set of
                                               leaves that require grad
                                               (the reverse of jax.jit of a
                                               scan's value_and_grad)

Outside a capture (every CPU tensor, and an eager step on the card) `cond`
and `bounded_while` are Python branches on a predicate read to the host
here, and nowhere else: the step's only host reads are these predicate
reads. Inside a capture that `compiled` started `cond` reads nothing: it
becomes two IF nodes of the graph, on `pred` and on `~pred`, as in
torch's `if_else_node` (torch/_higher_order_ops/
cudagraph_conditional_nodes.py). `bounded_while` runs only eagerly: its
one caller, the cached coloring's claim rounds, is a loop on the CPU
alone (on the card those rounds are one kernel launch that stops on the
device, ops/coloring_kernel.py), and a capture of it raises at its
first predicate read.

A branch returns only tensors it made or was given as `operands`, and
both branches return the same tree of tensors of the same shapes and
dtypes. Under a capture the merged output is the true
branch's: the false branch's leaves are copied into it inside the false
body, except where the true branch returned an operand (its leaf is then
not the branch's to overwrite) or one tensor twice; those leaves are
selected after both nodes with `torch.where(pred, ...)`, which is exact.

The IF nodes come from the kernel library (csrc/control.cu: a conditional
handle, a one-thread kernel that sets it from the predicate, the node,
and its body captured from a stream of its own), because torch 2.11's
CUDAGraph cannot capture one; it needs CUDA 12.4 or newer. While a graph
is captured every allocation of the capturing thread goes to the graph's
memory pool, the bodies' too.

`compiled` keys its cache on the function, the config, the device and
the state's shapes and dtypes, as `jax.jit` keys on static arguments and
shapes, and on whether tracing is on (trace.py): a graph captured with
tracing on is a capture of its own, with stage stamps and live counts in a
`trace.Recorder`'s rows, and the graph captured without it is left as it
is. It warms up with one eager call on a side stream, in which every
`cond` runs both branches (so the
kernels are built, the cluster sizes chosen and every per-device constant
made before the capture), then captures one call on static input buffers
under `torch.cuda.set_sync_debug_mode("error")`, so a host read or a
host-to-device copy in the step raises at the operation that does it. A
failed capture raises; nothing falls back to the eager call. A replay
ends with the outputs copied onto the inputs inside the graph (the scan's
carry) and the call's 0-d metrics written, as int32 bits, into row `k` of
a metrics buffer, `k` a device counter: one graph launch a step.

With grad enabled and an operand that requires grad, `cond` is
`_CondFn`, an autograd Function whose backward is a cond again: in a
capture each branch's backward runs in an IF body of its own, on the
forward's predicate and on the body stream its forward ran on (autograd
runs a node's backward on its forward's stream), so a captured backward
takes the branch the predicate takes when it replays. Its outputs are
fresh tensors each body writes, never a branch's result written in place.
A plain cond's outputs must not require grad under a capture: the check
raises.

`compiled_grad` (`GradStep`) captures the body of a rollout's
backward a step at a time: the step recomputed from static input buffers
(a checkpoint is copied in) with grad enabled, then `torch.autograd.grad`
into static adjoint buffers, the reverse scan's carry. autograd runs a
backward's nodes on its worker thread for the device, so the capture runs
there too (`_on_device_thread`: inside the backward of a one-node graph,
where a nested backward runs on the same thread), and the thread's
allocations, the recompute's and the backward's, go to the graph's pool.
The recompute's launches do not count (`_Capture.mark`): the forward
counted them; the backward's do, as the eager loop's backward would.

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

from . import trace
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
    counted: bool = True  # its launches count (not a backward's recompute)


class _Capture:
    """The bodies of the graph being captured and the launches in each."""

    def __init__(self, counts, streams=()):
        self.counts = counts
        self.streams = streams
        self.start = _snapshot()
        self.bodies: list = []
        self.stack: list = []
        self.inner = [0] * len(_COUNTERS)
        self.marked = None

    def mark(self):
        """From here on the launches count: those captured before (outside
        every body, and in the bodies opened so far) do not."""
        for body in self.bodies:
            body.counted = False
        self.marked = (_snapshot(), list(self.inner))

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
        """Launches captured outside every body (since the mark, if one was
        made)."""
        start, inner0 = self.marked or (self.start, [0] * len(self.inner))
        return [n - s - (i - i0) for n, s, i, i0 in zip(
            _snapshot(), start, self.inner, inner0)]


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
    one (see the module docstring). With grad enabled and an operand that
    requires grad it is `_CondFn`, whose backward is a cond again."""
    leaves, build_in = flatten(operands)
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        spec = {"fns": (true_fn, false_fn, build_in, name)}
        outs = _CondFn.apply(pred, spec, *leaves)
        return spec["build"](list(outs))
    if _WARM:
        t_out = true_fn(*operands)
        f_out = false_fn(*operands)
        return t_out if _read(pred) else f_out
    if not _capturing(pred):
        return true_fn(*operands) if _read(pred) else false_fn(*operands)

    pred = pred.reshape(()).to(torch.bool)
    taken = _storages(leaves)
    with _if_body(pred, name + ":true"):
        t_out = true_fn(*operands)
    t_leaves, build = flatten(t_out)
    ids = [id(t) for t in t_leaves]
    owned = [t.untyped_storage().data_ptr() not in taken
             and ids.count(id(t)) == 1 for t in t_leaves]
    select, dsts, srcs = [], [], []
    with _if_body(torch.logical_not(pred), name + ":false"):
        f_leaves, _ = flatten(false_fn(*operands))
        _same_tree(name, t_leaves, f_leaves)
        for k, (t, f) in enumerate(zip(t_leaves, f_leaves)):
            if t is f:
                continue
            if owned[k]:
                dsts.append(t)
                srcs.append(f)
            else:
                select.append(k)
        _copy_all(dsts, srcs)
    _no_grad_out(name, t_leaves + f_leaves)
    out = list(t_leaves)
    for k in select:
        out[k] = torch.where(pred, t_leaves[k], f_leaves[k])
    return build(out)


def _same_tree(name, t_leaves, f_leaves):
    if len(f_leaves) != len(t_leaves):
        raise ValueError(f"cond {name}: the branches return different trees")
    for k, (t, f) in enumerate(zip(t_leaves, f_leaves)):
        if t.shape != f.shape or t.dtype != f.dtype:
            raise ValueError(
                f"cond {name}: leaf {k} is {t.dtype} {tuple(t.shape)} in one "
                f"branch, {f.dtype} {tuple(f.shape)} in the other")


def _no_grad_out(name, leaves):
    """Under a capture a branch's autograd nodes run on its body's stream,
    which is not capturing when a backward runs: only `_CondFn` may hand a
    gradient out of a body."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        raise RuntimeError(
            f"{name}: a branch returns a tensor that requires grad while no "
            "operand does; pass the tensors it differentiates as operands")


@contextlib.contextmanager
def _branch(pred, flag: bool, name: str, mode: str):
    """The body of one branch: an IF node on `pred` (on `~pred` for the
    false branch) in a capture, the Python code itself otherwise."""
    if mode != "graph":
        yield
        return
    p = pred if flag else torch.logical_not(pred)
    with _if_body(p, f"{name}:{'true' if flag else 'false'}"):
        yield


class _CondFn(torch.autograd.Function):
    """The differentiable cond (torch's CondAutogradOp,
    torch/_higher_order_ops/cond.py, is the model). The forward runs a
    branch with grad enabled on detached operands inside its IF body (in
    a capture: both bodies, both IF nodes; in the warm-up: both branches;
    otherwise the taken one) and copies its leaves into fresh outputs
    there, so autograd never sees an in-place write into a branch's
    result; it keeps each branch's results with their autograd graphs. The
    backward is a cond again: in each branch's IF body, on the predicate
    and the body stream of the forward's, `torch.autograd.grad` of that
    branch's results, whose nodes then run on the stream they ran on. An
    output is differentiable when it is in a branch that ran; the input
    adjoints are zero where the branch that ran gives none."""

    @staticmethod
    def forward(ctx, pred, spec, *leaves):
        true_fn, false_fn, build, name = spec["fns"]
        need = ctx.needs_input_grad[2:]
        xs = [t.detach().requires_grad_() if n else t.detach()
              for t, n in zip(leaves, need)]
        mode = ("warm" if _WARM else "graph" if _capturing(pred)
                else "eager")
        pred = pred.reshape(()).to(torch.bool)
        taken = None if mode == "graph" else _read(pred)
        outs, results = None, {}
        for flag, fn in ((True, true_fn), (False, false_fn)):
            if mode == "eager" and flag != taken:
                continue
            with _branch(pred, flag, name, mode):
                with torch.enable_grad():
                    got, out_build = flatten(fn(*build(xs)))
                if outs is None:
                    outs = [torch.empty_like(t) for t in got]
                    spec["build"] = out_build
                _same_tree(name, outs, got)
                if mode != "warm" or flag == taken:
                    _copy_all(outs, got)
            results[flag] = got
        ctx.pred, ctx.taken, ctx.mode, ctx.name = pred, taken, mode, name
        ctx.xs, ctx.need, ctx.results = xs, need, results
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(*[
            o for k, o in enumerate(outs)
            if not any(r[k].requires_grad for r in results.values())])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *g_outs):
        wrt = [x for x, n in zip(ctx.xs, ctx.need) if n]
        graph = ctx.mode == "graph"
        gi = [torch.zeros_like(x) for x in wrt] if graph else None
        got = {}
        for flag, leaves in ctx.results.items():
            pairs = [(y, g) for y, g in zip(leaves, g_outs)
                     if g is not None and y.requires_grad]
            got[flag] = [None] * len(wrt)
            if not pairs:
                continue
            with _branch(ctx.pred, flag, ctx.name + ":grad", ctx.mode):
                with torch.enable_grad():
                    got[flag] = list(torch.autograd.grad(
                        [y for y, _ in pairs], wrt, [g for _, g in pairs],
                        allow_unused=True))
                if graph:
                    done = [(d, g) for d, g in zip(gi, got[flag])
                            if g is not None]
                    _copy_all([d for d, _ in done], [g for _, g in done])
        ctx.results = ctx.xs = None
        if graph:
            some = [any(got[f][j] is not None for f in got)
                    for j in range(len(wrt))]
            mine = [d if s else None for d, s in zip(gi, some)]
        else:
            mine = got[ctx.taken]
        it = iter(mine)
        return (None, None, *[next(it) if n else None for n in ctx.need])


def bounded_while(n_max: int, pred_fn, body_fn, carry):
    """while c < n_max and pred_fn(c, carry): carry = body_fn(c, carry);
    c += 1. `pred_fn` returns a 0-d bool tensor, read to the host each
    trip; `c` is static in each trip. Eager only: nothing captures it."""
    for c in range(n_max):
        if not _read(pred_fn(c, carry)):
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


class _Accounted:
    """A captured graph's launch accounting: `counts` (a device counter a
    conditional body), `bodies`, `top` (launches a replay outside every
    body), `replays` since `start`."""

    def start(self):
        self.counts.zero_()
        self.replays = 0

    def account(self, counts: list) -> dict:
        """Add the launches of the replays since `start` to the Python
        counters, from the bodies' counts read back (`counts`). Returns
        {body name: times it ran}."""
        self.counts_read = counts
        total = [self.replays * n for n in self.top]
        for body, c in zip(self.bodies, counts):
            if body.counted:
                for k, n in enumerate(body.own):
                    total[k] += c * n
        for (h, a), n in zip(_COUNTERS, total):
            if n:
                setattr(h, a, getattr(h, a) + n)
        ran = {}
        for body, c in zip(self.bodies, counts):
            ran[body.name] = ran.get(body.name, 0) + c
        return ran

    def finish(self) -> dict:
        """Read the body counters back (one host read) and `account`; a
        traced graph's rows moved out since `start` are read with them."""
        ran = self.account(self.counts[:len(self.bodies)].tolist())
        if self.rec is not None:
            self.rec.flush()
        return ran


def _warm_up(dev, run):
    """`run()` once with every cond's branches and every while's trips, on
    the capture's stream; the Python counters are as they were afterwards.
    Returns its result."""
    global _WARM
    side = _streams(dev)[0]
    side.wait_stream(torch.cuda.current_stream(dev))
    saved = _snapshot()
    _WARM = True
    try:
        with torch.cuda.stream(side):
            got = run()
    finally:
        _WARM = False
        _restore(saved)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    return got


@contextlib.contextmanager
def _capture(graph, dev, pool, counts):
    """Capture into `graph` on the capture's stream, under the sync debug
    mode "error", with a `_Capture` of the bodies; every allocation of this
    thread (the bodies' too) goes to `pool`. The Python counters are as
    they were afterwards. Yields the `_Capture`."""
    global _CAPTURE
    streams = _streams(dev)
    saved = _snapshot()
    cap = _CAPTURE = _Capture(counts, streams[1:])
    routed = False
    try:
        with torch.cuda.graph(graph, pool=pool, stream=streams[0]), \
                _sync_debug_error():
            torch._C._cuda_endAllocateToPool(dev.index, pool)
            torch._C._cuda_beginAllocateCurrentThreadToPool(dev.index, pool)
            routed = True
            yield cap
    finally:
        _CAPTURE = None
        _restore(saved)
        if routed:      # beginAllocate took a reference on the pool
            torch._C._cuda_releasePool(dev.index, pool)


class _OnDeviceThread(torch.autograd.Function):
    """Runs `holder["fn"]()` in its backward."""

    @staticmethod
    def forward(ctx, x, holder):
        ctx.holder = holder
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        ctx.holder["out"] = ctx.holder["fn"]()
        return g, None


def _on_device_thread(fn, device):
    """fn() on autograd's worker thread for the CUDA `device`: a backward
    called there runs on that thread too (reentrant), so a capture made
    there can route the allocations of its one thread to its pool, the
    backward's included."""
    holder = {"fn": fn}
    with torch.enable_grad():
        x = torch.zeros(1, device=device, requires_grad=True)
        y = _OnDeviceThread.apply(x, holder)
        torch.autograd.grad(y, x, torch.ones_like(y))
    return holder["out"]


class Compiled(_Accounted):
    """fn(state, cfg) -> (state, metrics of 0-d tensors) captured once as
    a CUDA graph on static input buffers. `rollout` replays it. Captured
    with tracing on, `rec` holds its trace rows (a row a replay, on the
    metrics' row counter): a stamp first, the stages fn marks, and `tail`
    after the carry and the metrics row."""

    def __init__(self, fn, cfg, state):
        leaves, self._build = flatten(state)
        dev = leaves[0].device
        self.inputs = [torch.empty(t.shape, dtype=t.dtype, device=dev)
                       for t in leaves]
        torch._foreach_copy_(self.inputs, leaves)
        self.counts = torch.zeros(MAX_BODIES, dtype=torch.int64, device=dev)
        self.row = torch.zeros(1, dtype=torch.int64, device=dev)

        n_metrics = _warm_up(dev, lambda: len(flatten(
            fn(self._build(self.inputs), cfg)[1])[0]))
        self.rows = torch.zeros((METRIC_ROWS, n_metrics), dtype=torch.int32,
                                device=dev)
        self.rec = (trace.Recorder("step", METRIC_ROWS, self.row)
                    if trace.enabled() else None)

        start = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with _capture(self.graph, dev, torch.cuda.graph_pool_handle(),
                      self.counts) as cap, trace.recording(self.rec):
            if self.rec is not None:
                self.rec.begin()
            out, metrics = fn(self._build(self.inputs), cfg)
            outs = flatten(out)[0]
            if len(outs) != len(self.inputs):
                raise ValueError("compiled: the state's tree changed")
            _carry(self.inputs, outs)
            self.rows.index_copy_(0, self.row, _pack(metrics)[None])
            self.row.add_(1)
            if self.rec is not None:
                self.rec.stamp("tail", row_offset=-1)
            self.top = cap.top()
        self.graph.instantiate()
        self.bodies = cap.bodies
        self._metrics = metrics
        self.capture_s = time.perf_counter() - start

    # --- a rollout: start, then load / replay / store per state, finish ---
    def load(self, state):
        torch._foreach_copy_(self.inputs, flatten(state)[0])

    def replay(self, steps: int, before=None):
        """`steps` replays; the metrics as a tree of [steps] tensors.
        `before(k)`, when given, runs before replay k (on the host, as it
        queues the replays: device work it queues runs before the
        replay)."""
        out = torch.empty((steps, self.rows.shape[1]), dtype=torch.int32,
                          device=self.rows.device)
        done = 0
        while done < steps:
            n = min(METRIC_ROWS, steps - done)
            self.row.zero_()
            for k in range(done, done + n):
                if before is not None:
                    before(k)
                if self.rec is not None:
                    self.rec.next()
                self.graph.replay()
            out[done:done + n].copy_(self.rows[:n])
            if self.rec is not None:
                self.rec.keep()
            done += n
        self.replays += steps
        return _unpack(out, self._metrics)

    def state(self):
        """A state cloned out of the static buffers."""
        return self._build([t.clone() for t in self.inputs])

    def store(self, dst_leaves):
        torch._foreach_copy_(dst_leaves, self.inputs)

    def rollout(self, state, steps: int):
        """(state after `steps` replays, metrics with [steps] leaves)."""
        with trace.span("rollout"):
            self.start()
            with trace.span("load"):
                self.load(state)
            with trace.span("launch"):
                metrics = self.replay(steps)
            with trace.span("clone"):
                out = self.state()
            with trace.span("finish"):
                self.finish()
        return out, metrics


def _carry(dsts, srcs):
    """dst <- src for each pair, in place and in one go: a source that is
    its destination is skipped, and one that lies in another destination's
    storage is cloned first (the copies run in no fixed order)."""
    mine = _storages(dsts)
    dst, src = [], []
    for d, o in zip(dsts, srcs):
        if o is d or (o.data_ptr() == d.data_ptr()
                      and o.stride() == d.stride() and o.shape == d.shape):
            continue
        if o.untyped_storage().data_ptr() in mine:
            o = o.clone()
        dst.append(d)
        src.append(o)
    _copy_all(dst, src)


# --- the compiled gradient -------------------------------------------------
# A rollout's backward, a step at a time in reverse, as a CUDA graph: the
# counterpart of the reverse of `jax.jit(jax.value_and_grad(...lax.scan...))`.
# `GradStep` holds, for one function, config, device, state shape and set of
# input leaves that require grad, the static buffers every backward step
# reads and writes: the step's input state (a checkpoint is copied in), the
# adjoint of each float leaf (the reverse scan's carry) and of each float
# metric. With grad enabled it recomputes the step from the static inputs
# (those in `mask` detached and requiring grad), then takes
# `torch.autograd.grad` of the outputs that require grad and the float
# metrics, from the adjoints, and writes the input adjoints into the
# adjoint buffers. `mask` is the same at every step: the caller's leaves
# and every leaf a step derives from one in the set, with every cond's
# branches (`_closure`), so one graph serves the whole rollout. On the card
# that body is captured once (after a warm-up that runs it, every cond's
# branches and both branches' backward) and replayed; on the CPU it runs as
# it is.


class GradStep(_Accounted):
    """The backward of one step of fn (see above): `run` is one replay of
    its graph on the card, the body itself on the CPU. `next_mask` and
    `metric_mask` are the state's and the metrics' leaves that require
    grad after a step; `capture_s` is the capture's seconds (the card).
    Captured with tracing on, `rec` holds its trace rows (a row a replay,
    on a row counter of its own): a stamp first, the stages of the
    recomputed step, `recompute` after it and `adjoint` after the
    backward and its carry."""

    def __init__(self, fn, cfg, state, need):
        leaves, self.build = flatten(state)
        dev = self.device = leaves[0].device
        self.fn, self.cfg = fn, cfg
        self.inputs = [torch.empty(t.shape, dtype=t.dtype, device=dev)
                       for t in leaves]
        torch._foreach_copy_(self.inputs, [t.detach() for t in leaves])
        self.adj = [torch.zeros(t.shape, dtype=t.dtype, device=dev)
                    if t.dtype.is_floating_point else None for t in leaves]
        self.counts = torch.zeros(MAX_BODIES, dtype=torch.int64, device=dev)
        self.graph, self.bodies, self.replays = None, [], 0
        self.rec = None
        self.mask = self._closure(tuple(need))
        if dev.type == "cuda":
            if trace.enabled():
                self.rec = trace.Recorder(
                    "grad", METRIC_ROWS,
                    torch.zeros(1, dtype=torch.int64, device=dev))
            self.pool = torch.cuda.graph_pool_handle()
            _warm_up(dev, self._body)
            self._capture()

    def _closure(self, mask):
        """The smallest set of leaves that holds `mask` and every leaf a
        step makes from one in it (each probe runs the step once, with
        grad and every cond's branches, and no backward)."""
        while True:
            outs, ms = self._probe(mask)
            grown = tuple(m or o for m, o in zip(mask, outs))
            if grown == mask:
                self.next_mask = outs
                self.metric_mask = tuple(m is not None for m in ms)
                self.adj_m = ms
                return mask
            mask = grown

    def _probe(self, mask):
        global _WARM
        saved = _snapshot()
        _WARM = True
        try:
            with torch.enable_grad():
                _, out, metrics = self._recompute(mask)
            # the metrics' adjoints (0-d), for those that require grad
            ms = [torch.zeros((), dtype=m.dtype, device=self.device)
                  if m.requires_grad else None for m in flatten(metrics)[0]]
            return tuple(o.requires_grad for o in flatten(out)[0]), ms
        finally:
            _WARM = False
            _restore(saved)

    def _recompute(self, mask):
        xs = [t.detach().requires_grad_() if m else t
              for t, m in zip(self.inputs, mask)]
        out, metrics = self.fn(self.build(xs), self.cfg)
        if len(flatten(out)[0]) != len(xs):
            raise ValueError("compiled_grad: the state's tree changed")
        return xs, out, metrics

    def _body(self):
        with torch.enable_grad():
            before = _snapshot()
            xs, out, metrics = self._recompute(self.mask)
            trace.stage("recompute")
            # the recompute's launches don't count: the forward counted them
            if _CAPTURE is not None:
                _CAPTURE.mark()
            else:
                _restore(before)
            ys, gys = [], []
            for y, a in zip(flatten(out)[0] + flatten(metrics)[0],
                            self.adj + self.adj_m):
                if a is not None and y.requires_grad:
                    ys.append(y)
                    gys.append(a)
            wrt = [x for x, m in zip(xs, self.mask) if m]
            got = (torch.autograd.grad(ys, wrt, gys, allow_unused=True)
                   if ys and wrt else [None] * len(wrt))
        adj = [a for a, m in zip(self.adj, self.mask) if m]
        zero = [a for a, g in zip(adj, got) if g is None]
        if zero:
            torch._foreach_zero_(zero)
        _carry([a for a, g in zip(adj, got) if g is not None],
               [g for g in got if g is not None])

    def _capture(self):
        """The body captured on autograd's worker thread (see
        `_on_device_thread`): the recompute and the backward's nodes all
        run there, so all their allocations go to the graph's pool."""
        start = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)

        def capture():
            with _capture(self.graph, self.device, self.pool,
                          self.counts) as cap, trace.recording(self.rec):
                if self.rec is not None:
                    self.rec.begin()
                self._body()
                if self.rec is not None:
                    self.rec.row.add_(1)
                    self.rec.stamp("adjoint", row_offset=-1)
                self.top = cap.top()
            return cap.bodies

        self.bodies = _on_device_thread(capture, self.device)
        self.graph.instantiate()
        self.capture_s = time.perf_counter() - start

    # --- a backward: start, then a checkpoint copied in and run a step ---
    def run(self):
        """One backward step on the static buffers."""
        if self.graph is None:
            self._body()
            return
        if self.rec is not None:
            self.rec.next()
        self.graph.replay()
        self.replays += 1

    def finish(self) -> dict:
        """On the card: read the body counters back (one host read) and
        add the backward's launches to the Python counters."""
        return {} if self.graph is None else super().finish()


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
_GRAD_CACHE: dict = {}


def _key(fn, cfg, state):
    leaves = flatten(state)[0]
    return (fn, cfg, str(leaves[0].device),
            tuple((tuple(t.shape), t.dtype) for t in leaves),
            trace.enabled())


def compiled(fn, cfg, state) -> Compiled:
    """The graph of fn(state, cfg) for this config, device, state shape and
    tracing state, captured at the first call."""
    key = _key(fn, cfg, state)
    got = _CACHE.get(key)
    if got is None:
        got = _CACHE[key] = Compiled(fn, cfg, state)
    return got


def compiled_grad(fn, cfg, state, need=None) -> GradStep:
    """The backward step of fn(state, cfg) for this config, device, state
    shape, tracing state and set of leaves that require grad (`need`, a
    bool a leaf; by default the state's leaves' `requires_grad`), made at
    the first call from `state` (on the card: captured)."""
    if need is None:
        need = [t.requires_grad for t in flatten(state)[0]]
    need = tuple(bool(n) for n in need)
    key = _key(fn, cfg, state) + (need,)
    got = _GRAD_CACHE.get(key)
    if got is None:
        got = _GRAD_CACHE[key] = GradStep(fn, cfg, state, need)
    return got


def clear():
    """Drop every cached graph and its memory pool."""
    _CACHE.clear()
    _GRAD_CACHE.clear()
