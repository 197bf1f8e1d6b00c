"""Device timing of a callable on the card, two ways: `graph_ms` replays
calls captured in a CUDA graph (device time, no host dispatch between
them), `cuda_ms` issues them from the host (the caller's time). Both are
measured by CUDA events after warm-up calls."""
from __future__ import annotations

import torch


def cuda_ms(fn, reps: int) -> float:
    """Mean time of one fn() call over `reps` calls issued from the host,
    by CUDA events, after three warm-up calls: it includes the host's
    dispatch of every op fn() issues."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Mean device time of one fn() call: `reps` calls captured in one CUDA
    graph and replayed `replays` times, by CUDA events, so that no host
    dispatch falls between the kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)
