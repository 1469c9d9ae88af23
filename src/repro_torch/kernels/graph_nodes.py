"""What one call puts on the card: the nodes of a CUDA graph captured around
it, read through the driver API (``libcuda``).  ``chip_smoke.py`` and the
card tests use it to show that a wrapper's call is one kernel launch and no
fill or copy beside it; the profiler often records nothing for a call of
one short kernel."""

from __future__ import annotations

import ctypes
from typing import Callable, List

import torch

# CUgraphNodeType (cuda.h)
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
              6: "wait_event", 7: "event_record", 8: "ext_semas_signal",
              9: "ext_semas_wait", 10: "mem_alloc", 11: "mem_free", 12: "batch_mem_op",
              13: "conditional"}


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUresult {rc}")


def captured_node_types(fn: Callable[[], object]) -> List[str]:
    """The node types of the work ``fn()`` enqueues, captured into a CUDA
    graph on a side stream after one warm call on that stream (first-use
    builds and per-stream buffers stay out of the graph)."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    _check(cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    _check(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    types = []
    for node in nodes[:count.value]:
        kind = ctypes.c_int(-1)
        _check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
               "cuGraphNodeGetType")
        types.append(NODE_TYPES.get(kind.value, str(kind.value)))
    return types
