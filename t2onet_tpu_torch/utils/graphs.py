"""CUDA graphs of a step's device work: one replay in place of the
operations that eager code launches one by one from Python.

`GraphCache.run` takes each call by the caller's key. No key (`None`)
runs the eager code and stores nothing. A key whose graph's weights have
not moved replays: the inputs copied in, the outputs cloned out.
Otherwise (the key's first sight, or its weights moved) the eager code
runs on the device's capture stream, and the caller's function is then
captured there over static copies of its inputs: after the eager run, so
that cuDNN's and cuBLAS's first-use work stays outside the capture, and
in thread-local mode, so that other threads may launch meanwhile. The
capture stream first waits for the caller's, where the inputs and
weights were written, so a block that an eager run frees is not reused
before the caller's stream has read it; the caller's stream then waits
for it. A device's graphs share one memory pool.

A graph reads the module's weights and buffers where they were at the
capture. `.to()`, even onto the module's own device, flattens an LSTM's
weights into new storage and frees the old: `Weights.moved()` tells.
"""

import threading

import torch


class Weights:
    """A module's parameters and buffers, and where each lived when
    taken."""

    def __init__(self, module):
        self.tensors = [*module.parameters(), *module.buffers()]
        self.where = [t.data_ptr() for t in self.tensors]

    def moved(self) -> bool:
        return [t.data_ptr() for t in self.tensors] != self.where


class Graph:
    """A CUDA graph of `fn(*inputs)` over static copies of `inputs`; the
    tensors of the tuple `fn` returns are its static outputs."""

    def __init__(self, module, fn, inputs, pool, stream):
        self.weights = Weights(module)
        self.inputs = [t.detach().clone() for t in inputs]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            self.outputs = tuple(fn(*self.inputs))

    def __call__(self, *inputs):
        """Copy `inputs` in, replay, and return the outputs with each
        tensor cloned: the next replay overwrites the static ones."""
        with torch.no_grad():
            for static, t in zip(self.inputs, inputs):
                static.copy_(t)
        self.graph.replay()
        return tuple(o.clone() if isinstance(o, torch.Tensor) else o
                     for o in self.outputs)


class GraphCache:
    """Graphs by key under one lock, which keeps one thread at a time on
    the graphs and their static buffers."""

    def __init__(self):
        self._graphs = {}
        self._capture = {}              # device: (stream, pool)
        self._lock = threading.Lock()

    def values(self):
        with self._lock:
            return list(self._graphs.values())

    def run(self, key, module, fn, eager, replay):
        """One call, and how it ran: (result, "eager", "replay" or
        "capture"). `module`: whose weights `fn(*inputs)` reads; `eager()`:
        (the result, the inputs); `replay(graph)`: the result from
        `graph(*inputs)`."""
        if key is None:
            return eager()[0], "eager"
        with self._lock:
            graph = self._graphs.get(key)
            if graph is not None and not graph.weights.moved():
                return replay(graph), "replay"
            # a moved graph's static buffers go back to the pool first
            self._graphs.pop(key, None)
            device = next(module.parameters()).device
            if device not in self._capture:
                self._capture[device] = (torch.cuda.Stream(device),
                                         torch.cuda.graph_pool_handle())
            stream, pool = self._capture[device]
            caller = torch.cuda.current_stream(device)
            stream.wait_stream(caller)
            with torch.cuda.stream(stream):
                result, inputs = eager()
                self._graphs[key] = Graph(module, fn, inputs, pool, stream)
            caller.wait_stream(stream)
            return result, "capture"
