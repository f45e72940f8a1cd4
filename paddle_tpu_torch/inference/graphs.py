"""Captured device programs of the serving engine.

Counterpart of the JAX engine's compiled programs (``jax.jit`` of its
tick, spec tick and prompt functions, ``paddle_tpu/inference/serving.py``).
A :class:`Program` is one function over static buffers: its inputs (block
tables, lengths, last tokens, the sampling arrays, ...) and its outputs
(tokens, or a prompt's logits row) are tensors allocated once, before any
capture, and the function reads the inputs and ``copy_``s its results into
the outputs.  On the card the function is captured once into a
``torch.cuda.CUDAGraph`` and replayed; on the CPU, or when the caller asks
for eager programs, ``replay()`` calls it directly.  A function may write
its inputs too: the tick writes its final lengths and last tokens back
into its own, so a chained tick reads them on the card.

Host arrays reach the inputs through pinned staging buffers and
non-blocking copies (:meth:`Program.load`), and outputs come back the same
way (:meth:`Program.fetch`), so the host never waits for the card at a
dispatch.  Each program keeps two sets of both, alternated: at most two
ticks are in flight, and a set is reused only after an event says its last
copy ran.

The kernel wrappers count their launches in Python, so under replay they
would count once, at capture.  A capture records each wrapper's
increments (``launches``, ``plain_calls``, ``dequant_calls``) and
:meth:`Program.replay` adds them again at every replay; the captures' own
warm-up runs are not counted.
"""

from __future__ import annotations

import time

import torch

from ..observability import telemetry

__all__ = ["Program", "counters", "snapshot", "restore"]

_TURNS = 2      # ticks in flight at most: one harvested, one dispatched


def counters():
    """``(function, attribute)`` of every launch, plain-route and
    dequantize-route count of the kernel wrappers."""
    from ..ops import flash_attention, moe, paged_attention, weight_only
    out = {}
    for mod in (flash_attention, paged_attention, moe, weight_only):
        for fn in vars(mod).values():
            for attr in ("launches", "plain_calls", "dequant_calls"):
                if callable(fn) and isinstance(getattr(fn, attr, None), int):
                    out[id(fn), attr] = (fn, attr)
    return list(out.values())


def snapshot():
    return [(fn, attr, getattr(fn, attr)) for fn, attr in counters()]


def restore(snap) -> None:
    for fn, attr, value in snap:
        setattr(fn, attr, value)


_SIDE = {}


def _capture_stream(device) -> "torch.cuda.Stream":
    """The one side stream of every capture on ``device``: cuBLAS keeps a
    workspace for each stream it has run on, for the life of the process,
    so a stream per capture would leave one workspace behind for each."""
    side = _SIDE.get(device)
    if side is None:
        side = _SIDE[device] = torch.cuda.Stream(device)
    return side


class _Fetch:
    """Outputs on their way to the host: pinned copies enqueued behind the
    replay, and the event that says they landed.  :meth:`sync` only waits
    (a watchdog may run it on a helper thread); :meth:`copy` takes the
    host copies after it."""

    __slots__ = ("arrays", "event")

    def __init__(self, arrays, event):
        self.arrays = arrays
        self.event = event

    def sync(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def copy(self) -> dict:
        return {n: a.copy() for n, a in self.arrays.items()}

    def wait(self) -> dict:
        self.sync()
        return self.copy()


class Program:
    """``fn(inputs, outputs)`` over static buffers: ``inputs`` and
    ``outputs`` map names to tensors on one device.  ``inert`` gives the
    value an input holds while the program is captured or warmed (0 where
    not given): all-zero tables and lengths route every write to the pad
    block 0, so a capture touches no cached key or value."""

    def __init__(self, fn, inputs: dict, outputs: dict, inert: dict = None):
        self.fn = fn
        self.inputs = inputs
        self.outputs = outputs
        self.inert = dict(inert or {})
        self.device = next(iter(inputs.values())).device
        self.cuda = self.device.type == "cuda"
        self.graph = None
        self.increments = []     # (function, attribute, count) per replay
        self.replays = 0
        self._turn = 0
        if self.cuda:
            pin = dict(pin_memory=True)
            self._stage = [{n: torch.empty(t.shape, dtype=t.dtype, **pin)
                            for n, t in inputs.items()}
                           for _ in range(_TURNS)]
            self._back = [{n: torch.empty(t.shape, dtype=t.dtype, **pin)
                           for n, t in outputs.items()}
                          for _ in range(_TURNS)]
            self._stage_ev = [None] * _TURNS
            self._back_ev = [None] * _TURNS

    # ------------------------------------------------------------ capture
    def _run(self) -> None:
        with torch.no_grad():
            self.fn(self.inputs, self.outputs)

    def _inert_run(self, body) -> None:
        """``body()`` on inert inputs, the inputs put back afterwards."""
        saved = {n: t.clone() for n, t in self.inputs.items()}
        for n, t in self.inputs.items():
            t.fill_(self.inert.get(n, 0))
        try:
            body()
        finally:
            for n, t in self.inputs.items():
                t.copy_(saved[n])

    def warm(self) -> None:
        """One eager run on inert inputs, its launches not counted (the
        eager programs' counterpart of a capture)."""
        snap = snapshot()
        try:
            self._inert_run(self._run)
        finally:
            restore(snap)

    def capture(self, pool) -> None:
        """Capture the function into a CUDA graph on inert inputs: a
        warm-up run on the capture stream (cuBLAS and the kernel library
        settle their workspaces and attributes there), then the capture
        on the same stream into the graph pool ``pool`` shared by the
        engine's programs.  A failed capture raises; nothing falls back to the
        eager path."""
        t0 = time.perf_counter()
        snap = snapshot()
        graph = torch.cuda.CUDAGraph()
        main = torch.cuda.current_stream(self.device)
        side = _capture_stream(self.device)

        def body():
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self._run()
            main.wait_stream(side)
            before = {(id(fn), a): v for fn, a, v in snapshot()}
            with torch.no_grad(), torch.cuda.graph(graph, pool=pool,
                                                   stream=side):
                self.fn(self.inputs, self.outputs)
            self.increments = [
                (fn, a, v - before[id(fn), a]) for fn, a, v in snapshot()
                if v != before[id(fn), a]]
        try:
            self._inert_run(body)
        finally:
            restore(snap)
        self.graph = graph
        telemetry.observe_compile("graph_capture", time.perf_counter() - t0)

    # ------------------------------------------------------------ traffic
    def load(self, **arrays) -> None:
        """Copy host arrays (numpy or scalars) into the named inputs, in
        stream order: through pinned staging buffers and non-blocking
        copies on the card, directly on the CPU."""
        if not self.cuda:
            for n, a in arrays.items():
                self.inputs[n].numpy()[...] = a
            return
        turn = self._turn
        ev = self._stage_ev[turn]
        if ev is not None:
            ev.synchronize()        # the set's last copies have run
        stage = self._stage[turn]
        for n, a in arrays.items():
            stage[n].numpy()[...] = a
            self.inputs[n].copy_(stage[n], non_blocking=True)
        ev = self._stage_ev[turn] = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))

    def carry(self, other: "Program", *names) -> None:
        """Take the named inputs from ``other``'s on the card (a chained
        tick of another program reads what the last one left there)."""
        if other is not self:
            for n in names:
                self.inputs[n].copy_(other.inputs[n])

    def replay(self) -> None:
        if self.graph is None:
            self._run()
        else:
            self.graph.replay()
            for fn, attr, n in self.increments:
                setattr(fn, attr, getattr(fn, attr) + n)
        self.replays += 1
        self._turn = (self._turn + 1) % _TURNS

    def fetch(self, *names) -> _Fetch:
        """Start copying the named outputs to the host behind the last
        replay; ``.wait()`` on the result returns numpy copies."""
        if not self.cuda:
            # the CPU ran the program already; copy now, before a chained
            # replay overwrites the outputs
            return _Fetch({n: self.outputs[n].numpy().copy() for n in names},
                          None)
        turn = self._turn
        ev = self._back_ev[turn]
        if ev is not None:
            ev.synchronize()
        back = self._back[turn]
        for n in names:
            back[n].copy_(self.outputs[n], non_blocking=True)
        ev = self._back_ev[turn] = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return _Fetch({n: back[n].numpy() for n in names}, ev)

    def abandon(self, fetch: _Fetch, timeout: float) -> bool:
        """Give up on a fetch that will never be harvested: wait at most
        ``timeout`` seconds for its copies to land.  If they have not, its
        turn gets new pinned buffers and no event, so the turn's next
        :meth:`fetch` neither waits on the hung event nor shares buffers
        with copies still pending.  Returns whether the copies landed."""
        ev = fetch.event
        if ev is None:
            return True
        end = time.monotonic() + timeout
        while not ev.query():
            if time.monotonic() >= end:
                for turn in range(_TURNS):
                    if self._back_ev[turn] is ev:
                        self._back[turn] = {
                            n: torch.empty(t.shape, dtype=t.dtype,
                                           pin_memory=True)
                            for n, t in self.outputs.items()}
                        self._back_ev[turn] = None
                return False
            time.sleep(0.001)
        return True

