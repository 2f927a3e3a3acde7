"""Positive: host-side effects inside compiled and captured bodies.

The compiled step sleeps (a graph break at every call — or, baked in,
at trace time only); the compiled compute reads the wall clock through
a helper (the timestamp is traced once and baked into the compiled
graph, so every later step logs the same "time"); the metrics counter
increments during tracing only and then silently stops counting. The
same holds of a CUDA-graph capture, below the reference's cases.
"""

import time

import torch


class _Counter:
    def inc(self, n=1):
        pass


step_metric = _Counter()


@torch.compile
def train_step(params, batch):
    time.sleep(0.01)                      # host block inside compile
    step_metric.inc()                     # metric RPC inside compile
    return torch.mean(batch) + params


def _stamp(x):
    return x * time.time()                # wall-clock read


def compute(x):
    return _stamp(x) + 1.0


def make_fn():
    return torch.compile(compute)         # compile root via call form


# --- CUDA graphs: the Python of a capture runs once; replay() never ---

def _log_step(x):
    step_metric.inc()                     # metric RPC, reached from capture
    return x


def capture(static_in, static_out):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        static_out.copy_(static_in * 2)
        t0 = time.perf_counter()          # wall-clock read at capture only
        _log_step(static_out)
    return g, t0


def _paced(x):
    time.sleep(0.001)                     # runs once, at capture
    return x * 2


def make_graphed(sample):
    return torch.cuda.make_graphed_callables(_paced, (sample,))
