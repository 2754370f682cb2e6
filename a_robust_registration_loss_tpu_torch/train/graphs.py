"""CUDA graphs: the port's counterpart of the JAX package's ``jax.jit`` over
a ``lax.scan`` body.

The JAX package compiles a block of classical steps (``train/classical.py``
``run`` and ``run_batch``) and a whole epoch over a device-resident dataset
(``train/harness.py``, the scanned epoch) into one XLA program each, so the
host dispatches once where PyTorch launches hundreds of kernels. Here a
step is captured once into a ``torch.cuda.CUDAGraph`` and replayed: the
host launches one graph, not its kernels.

- ``Graph``: ``fn()`` captured once and replayed. ``fn`` reads and writes
  only tensors that outlive it (static buffers): the caller fills the
  inputs before a replay and reads the outputs after it, before the next
  replay overwrites them. A step that carries state (``step_graph``) ends
  its capture in ``copy_`` calls of the new carry into the old one, so the
  graph updates itself.
- ``Segment``: a differentiable piece of a step, its forward and its
  backward captured in two graphs, for steps that a host wait splits (the
  trainers' SVD solves read the host, which a capture refuses): the pieces
  between the solves replay, the solves and their backward run eagerly,
  and autograd strings them together. Under ``torch.no_grad`` (or with no
  input that needs a gradient) it is a ``Graph``.

Parameters that two pieces use (FMR's encoder runs before its solve and
after it) go from piece to piece as taps (``tap``, ``swapped``): each piece
but the last ends by returning a view of every parameter, and the next
piece runs with the parameters swapped for those views. A parameter's
gradient then sums the later piece's part first and the earlier piece's
after it, one term at a time, the order in which one eager backward
through the whole step adds them, so the graphs' gradients equal the eager
step's bit for bit.

Nothing here warms up: the callers run their first step eagerly on the
run's own state (it loads the kernel library, builds the cuBLAS handles
and advances the run as every later step does), then capture. A capture
runs no kernel, so it changes no state.

Launch counts: the kernel wrappers' counters (``ops/cuda/_build.py``
``COUNTERS``) count a launch when the wrapper's Python runs, which for a
graph is once, at capture. Each graph takes back what its capture counted,
keeps it as its per-replay counts (``counts``) and adds them on every
replay, so the counters read as they would after the same steps run
eagerly.

Every class raises on a CPU tensor: on the CPU the callers run their steps
eagerly, through the same static buffers.
"""

from __future__ import annotations

import contextlib
import gc

import torch
from torch.utils import _pytree

from a_robust_registration_loss_tpu_torch.ops.cuda._build import COUNTERS


def _snapshot():
    return {name: c.copy() for name, c in COUNTERS.items()}


def _take_back(before):
    """Restore the counters to ``before``; return what was counted since,
    {(counter, key): n} without zeros."""
    out = {}
    for name, c in COUNTERS.items():
        was = before.get(name, {})  # registered during the capture (a wrapper imported lazily)
        for key in set(c) | set(was):
            n = c[key] - was.get(key, 0)
            if n:
                out[(name, key)] = n
        c.clear()
        c.update(was)
    return out


def _add(counts):
    for (name, key), n in counts.items():
        COUNTERS[name][key] += n


def _require_cuda(tensors, what):
    for t in tensors:
        if isinstance(t, torch.Tensor) and not t.is_cuda:
            raise ValueError(f"{what}: a CUDA graph takes CUDA tensors, got one on {t.device} "
                             "(on the CPU the step runs eagerly)")


def _capture(graph, fn, pool=None):
    """(fn's output, the launches the capture counted, taken back). The
    garbage collector does not run during it: a graph that it frees during
    a capture breaks the capture."""
    before = _snapshot()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool):
            out = fn()
    finally:
        if enabled:
            gc.enable()
    return out, _take_back(before)


class Graph:
    """``fn()`` captured at construction; ``replay()`` runs it and returns
    its (static) output. ``inputs``: the static tensors fn reads, checked
    to be on the card."""

    def __init__(self, fn, inputs=()):
        _require_cuda(_pytree.tree_leaves(inputs), "Graph")
        self.graph = torch.cuda.CUDAGraph()
        self.out, self.counts = _capture(self.graph, fn)

    def replay(self):
        self.graph.replay()
        _add(self.counts)
        return self.out


def copy_carry(dst, src):
    """``dst <- src`` leaf by leaf, over two pytrees of one structure."""
    for d, s in zip(_pytree.tree_leaves(dst), _pytree.tree_leaves(src)):
        if d is not s:
            d.copy_(s)


def step_graph(step, carry, inputs):
    """The graph of ``carry, out = step(carry, *inputs)`` that updates
    ``carry`` (a pytree of static tensors) in place: its replay returns
    ``out``, the step's other outputs."""
    def body():
        new, out = step(carry, *inputs)
        copy_carry(carry, new)
        return out
    return Graph(body, (carry, inputs))


def tap(tensors):
    """Views of ``tensors``: a piece's last outputs, taken after all its
    work, so that in its backward their gradients reach the tensors
    first."""
    return tuple(t.view_as(t) for t in tensors)


@contextlib.contextmanager
def swapped(model, names, tensors):
    """``model``'s parameters ``names`` (``named_parameters()``'s) replaced
    by ``tensors`` inside the block."""
    slots = []
    for name, t in zip(names, tensors):
        path, _, attr = name.rpartition(".")
        owner = model.get_submodule(path)
        slots.append((owner, attr, owner._parameters[attr]))
        owner._parameters[attr] = t
    try:
        yield
    finally:
        for owner, attr, p in slots:
            owner._parameters[attr] = p


class _Replay(torch.autograd.Function):
    """A captured segment in autograd: the forward replays its forward
    graph, the backward its backward graph."""

    @staticmethod
    def forward(ctx, seg, *inputs):
        ctx.seg = seg
        ctx.set_materialize_grads(False)
        return seg._forward(inputs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        return (None, *ctx.seg._backward(grads))


def _copy_into(pairs):
    """dst <- src for each (dst, src), in one multi-tensor launch."""
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [x for _, x in pairs])


class Segment:
    """A piece of a step, ``fn(*inputs)`` -> a pytree of tensors, replayed
    from CUDA graphs. ``params``: the leaf tensors fn reads without taking
    them as inputs (a model's parameters), which take gradients.

    The first call captures: the static inputs alias the tensors of that
    call (a later call with other storage copies into them; one with the
    same storage, such as an earlier graph's static output, copies
    nothing), then the forward graph and, where a gradient is enabled and an
    input or parameter needs one, the backward graph, in one memory pool.
    Then every call replays the forward; autograd replays the backward."""

    def __init__(self, fn, params=()):
        self.fn = fn
        self.params = tuple(params)
        self.fwd = self.bwd = None

    def _build(self, inputs):
        _require_cuda(inputs + self.params, "Segment")
        self.static = tuple(x.detach().requires_grad_(x.requires_grad) for x in inputs)
        self.fwd = torch.cuda.CUDAGraph()
        out, self.fwd_counts = _capture(self.fwd, lambda: self.fn(*self.static))
        leaves, self.spec = _pytree.tree_flatten(out)
        # the outputs keep the capture's autograd graph, and with it the
        # parameters' AccumulateGrad nodes, made on the capture stream: a
        # node made again by an eager call, on the default stream, makes a
        # later backward capture through it wait on the default stream,
        # which a capture refuses
        self.out = tuple(leaves)
        surface = self.static + self.params
        self.wants = [x.requires_grad for x in surface]
        wanted = [x for x in surface if x.requires_grad]
        outs = [o for o in self.out if o.requires_grad]
        # zeros stand for a gradient that does not come (a tap no later
        # piece reads); ``written`` says which buffers hold one that did
        self.grad_out = [torch.zeros_like(o) if o.requires_grad else None for o in self.out]
        self.written = [False] * len(self.out)
        self.grad_in = None
        self.bwd_counts = {}
        if torch.is_grad_enabled() and wanted and outs:
            self.bwd = torch.cuda.CUDAGraph()
            grads, self.bwd_counts = _capture(
                self.bwd, lambda: torch.autograd.grad(
                    outs, wanted, [g for g in self.grad_out if g is not None],
                    allow_unused=True),
                pool=self.fwd.pool())
            it = iter(grads)
            self.grad_in = [next(it) if w else None for w in self.wants]
        self.replays = 0

    def _forward(self, inputs):
        _copy_into([(s, x) for s, x in zip(self.static, inputs)
                    if s.data_ptr() != x.data_ptr()])
        self.fwd.replay()
        _add(self.fwd_counts)
        self.replays += 1
        return tuple(o.detach() for o in self.out)

    def _backward(self, grads):
        pairs = []
        for i, (s, g) in enumerate(zip(self.grad_out, grads)):
            if s is None:
                continue
            if g is None:
                if self.written[i]:
                    s.zero_()
                    self.written[i] = False
                continue
            if s.data_ptr() != g.data_ptr():
                pairs.append((s, g))
            self.written[i] = True
        _copy_into(pairs)
        self.bwd.replay()
        _add(self.bwd_counts)
        return tuple(None if g is None else g.detach() for g in self.grad_in)

    def __call__(self, *inputs):
        if self.fwd is None:
            self._build(inputs)
        if self.bwd is None:
            with torch.no_grad():
                out = self._forward(inputs)
        else:
            out = _Replay.apply(self, *inputs, *self.params)
        return _pytree.tree_unflatten(list(out), self.spec)

