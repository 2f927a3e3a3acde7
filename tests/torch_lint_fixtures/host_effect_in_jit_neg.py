"""Negative: compiled and captured bodies are pure; host effects live
outside them.

Timing the compiled function from the caller, sleeping in the driver
loop, and bumping metrics after device work completes are all correct
placements — none of those functions is reachable from a root.
"""

import time

import torch


class _Counter:
    def inc(self, n=1):
        pass


step_metric = _Counter()


@torch.compile
def train_step(params, batch):
    return torch.mean(batch) + params


def _loss(params, batch):
    return torch.mean(batch) + params


def make_fn():
    return torch.compile(_loss)


def driver_loop(params, batches):
    fn = make_fn()
    for batch in batches:
        t0 = time.perf_counter()          # timing around the compile: fine
        params = fn(params, batch)
        step_metric.inc()                 # metric after device work
        time.sleep(0.001)                 # host pacing in the driver
    return params, time.perf_counter() - t0


# --- CUDA graphs: host effects around the capture, not in it ---

def capture(static_in, static_out):
    g = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()              # before the capture: fine
    with torch.cuda.graph(g):
        static_out.copy_(static_in * 2)
    step_metric.inc()                     # after it: fine
    return g, time.perf_counter() - t0


def replay(g, steps):
    for _ in range(steps):
        g.replay()
        step_metric.inc()                 # per replay, outside the graph


# sharded_jit is not a root: its body runs eagerly on every call
def sharded_body(x):
    from ray_tpu_torch.parallel.presets import sharded_jit

    @sharded_jit
    def f(y):
        step_metric.inc()
        return y * time.time()

    return f(x)


def compile(source):                      # not torch's: the builtin's name
    return source


def uses_builtin_name():
    return compile(_stamp_free)


def _stamp_free():
    return time.time()
