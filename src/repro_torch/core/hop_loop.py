"""The loop runner of both search loops: the disk loop (core/search_kernel.py
`_hop`) and the MemGraph loop (core/vamana.py `_mem_hop`).

A hop maps a state (a NamedTuple of (B, ...) tensors) to the next with fixed
shapes and no host sync; a finished query keeps its state. `hop_loop` steps
it while a query is open. On a CUDA device, for a caller that passes a cache
(`HopGraphs`), each iteration replays one CUDA graph of the hop, captured
once per `graph_key`; everywhere else the hop runs op by op. Either way the
host reads one flag an iteration. Each loop's owner keeps its own cache:
search_kernel one for the process, a MemGraph one beside its device arrays.
"""
from __future__ import annotations

from collections import OrderedDict

import torch


def graphs_on(device) -> bool:
    """Whether a loop replays captured CUDA graphs on `device`."""
    return device.type == "cuda"


def graph_key(device, batch: int, reads, static: dict) -> tuple:
    """The cache key of a hop's graph: the device, the batch size, the
    address, shape, strides and dtype of every tensor the graph reads in
    place, and every static argument. Tensors uploaded anew get another
    key, so no graph replays a stale address."""
    return (str(device), batch,
            tuple((x.data_ptr(), tuple(x.shape), x.stride(), x.dtype)
                  for x in reads),
            tuple(static.items()))


class _Eager:
    """A loop, op by op: the path off the card. `live(state)` gives the
    (B,) mask of the queries still open."""

    def __init__(self, hop, t, state, live):
        self.hop, self.t, self.state = hop, t, state
        self.live_of = live
        self.live = live(state)

    def more(self) -> bool:
        return bool(self.live.any())

    def step(self) -> None:
        self.state = self.hop(self.t, self.state, self.live)
        self.live = self.live_of(self.state)

    def result(self):
        return self.state


class _HopGraph:
    """One hop captured as a CUDA graph over static buffers: copies of the
    inputs named in `copied` (what a call brings anew) and of the state (a
    NamedTuple of tensors, or None where unused). A replay maps the state
    buffers to the next state in place, then writes the next live mask and
    its any() into `go`, so the host reads one flag an iteration. The graph
    reads the other inputs at the addresses its cache key names and holds
    none of them. Warm-up and capture run on the buffers, never on a
    call's state, so capturing advances no query."""

    WARMUP = 3

    def __init__(self, hop, t, state, live, copied, pool):
        self.live_of = live
        self.inputs = {f: getattr(t, f).clone() for f in copied}
        self.state = type(state)(*(None if x is None else x.clone()
                                   for x in state))
        self.live = live(self.state)
        self.go = self.live.any()
        ins = t._replace(**self.inputs)

        def step():
            new = hop(ins, self.state, self.live)
            for buf, x in zip(self.state, new):
                if x is not buf:
                    buf.copy_(x)
            self._check()

        self.graph = self._capture(step, t.q.device, pool)

    @staticmethod
    def _capture(step, device, pool):
        """`step` warmed up on a side stream, then captured."""
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(_HopGraph.WARMUP):
                step()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            step()
        return graph

    def _check(self) -> None:
        self.live.copy_(self.live_of(self.state))
        self.go.copy_(self.live.any())

    def load(self, t, state) -> None:
        """Copy a call's inputs and initial state into the buffers."""
        for f, buf in self.inputs.items():
            buf.copy_(getattr(t, f))
        for buf, x in zip(self.state, state):
            if buf is not None:
                buf.copy_(x)
        self._check()

    def more(self) -> bool:
        return bool(self.go)

    def step(self) -> None:
        self.graph.replay()

    def result(self):
        """The final state, copied out of the buffers the next call
        overwrites."""
        return type(self.state)(*(None if x is None else x.clone()
                                  for x in self.state))


class HopGraphs:
    """The captured hops, one a cache key, the least recently used dropped
    past `capacity`; all share one memory pool, and one replays at a time.
    `hops` counts the iterations replayed from a graph, `captures` the
    graphs captured."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self.graphs: OrderedDict = OrderedDict()
        self.hops = 0
        self.captures = 0
        self._pool = None

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def get(self, key, capture):
        """The graph under `key`, made by `capture()` on a miss."""
        graph = self.graphs.pop(key, None)
        if graph is None:
            while len(self.graphs) >= self.capacity:
                self.graphs.popitem(last=False)
            graph = capture()
            self.captures += 1
        self.graphs[key] = graph
        return graph

    def counts(self) -> tuple:
        """(iterations replayed from a graph, graphs captured) so far."""
        return self.hops, self.captures


def _run(runner, tracer, span) -> int:
    """Steps `runner` while a query is live; returns the iterations. A
    host-clock `tracer` gets a `search.sync` span for each loop check's
    host sync and a `span` span for each iteration (its work, then the
    next check and its sync)."""
    iters, hop = 0, None
    while True:
        if tracer:
            sync = tracer.begin("search.sync", "search")
        go = runner.more()
        if tracer:
            tracer.end(sync)
            if hop is not None:
                tracer.end(hop)
        if not go:
            return iters
        if tracer:
            hop = tracer.begin(span, "search")
        runner.step()
        iters += 1


def hop_loop(hop, t, state, live, *, graphs, reads, static, copied,
             tracer=None, span="search.hop"):
    """Runs `hop(t, state, live)` while `live(state)` has a query open and
    returns the final state. `t` is a NamedTuple of inputs with the batch's
    queries as `t.q` (B, d). Each iteration replays the graph under
    `graph_key(device, B, reads, static)` when the owner passes its cache
    `graphs`, `graphs_on` the device, and `static["max_iters"]` leaves a
    hop to take; a miss captures it, holding the inputs named in `copied`
    in buffers and reading the tensors `reads` in place. Otherwise the hop
    runs op by op. A host-clock `tracer` gets the loop's spans (`_run`),
    each iteration's under the name `span`."""
    device = t.q.device
    # with no hop to take the loop only checks; a graph's warm-up would
    # still run one (and index an empty page trace)
    if graphs is not None and static["max_iters"] > 0 and graphs_on(device):
        runner = graphs.get(
            graph_key(device, t.q.shape[0], reads, static),
            lambda: _HopGraph(hop, t, state, live, copied, graphs.pool()))
        runner.load(t, state)
    else:
        graphs = None
        runner = _Eager(hop, t, state, live)
    iters = _run(runner, tracer, span)
    if graphs is not None:
        graphs.hops += iters
    return runner.result()
