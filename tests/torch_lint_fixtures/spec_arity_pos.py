"""Positive: sharded-call specs disagree with the wrapped function.

`two_arg` takes two positional arguments but in_specs carries three
specs; `pair` returns a 2-tuple but out_specs promises three. Both
blow up only once the call runs under a bound mesh — on the cards,
not in CPU tests that never bind one.
"""

from ray_tpu_torch.parallel.presets import _shard_map, sharded_jit
from ray_tpu_torch.parallel.sharding import PartitionSpec as P


def two_arg(x, y):
    return x + y


def pair(x, y):
    return x, y


def wrong_in(mesh, xs, ys):
    f = _shard_map(two_arg, mesh,
                   (P("dp"), P(), P()),                # 3 specs, 2 args
                   P())
    return f(xs, ys)


def wrong_out(mesh, xs, ys):
    f = _shard_map(pair, mesh,
                   (P("dp"), P("dp")),
                   (P(), P(), P()))                    # 3 specs, 2-tuple
    return f(xs, ys)


# --- the port's other sharded-call forms ---

@sharded_jit(in_specs=(P("dp"), P(), P()), out_specs=P())   # 3 specs
def decorated(x, y):
    return x + y


def late_bound(xs):
    return sharded_jit(two_arg, in_specs=(P("dp"),),        # 1 spec
                       out_specs=P())(xs)


def placed(xs, ys):
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    f = local_map(pair, out_placements=([Shard(0)], [Shard(0)], [Shard(0)]),
                  in_placements=([Shard(0)], [Shard(0)]))  # 3 outs, 2-tuple
    return f(xs, ys)
