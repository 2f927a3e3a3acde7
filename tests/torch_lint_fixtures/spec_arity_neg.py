"""Negative: spec arities line up, or are not statically checkable.

Matching in/out arities stay clean; so do non-literal specs (a
variable or single spec records arity -1), functions taking
*args, and defaulted trailing arguments whose spec may be
omitted or supplied.
"""

from ray_tpu_torch.parallel.presets import _shard_map, sharded_jit
from ray_tpu_torch.parallel.sharding import PartitionSpec as P


def two_arg(x, y):
    return x + y


def pair(x, y):
    return x, y


def with_default(x, scale=1.0):
    return x * scale


def matched(mesh, xs, ys):
    f = _shard_map(pair, mesh,
                   (P("dp"), P("dp")),
                   (P(), P()))
    return f(xs, ys)


def single_spec(mesh, xs, ys):
    # a single out spec: the result is one tensor — arity -1
    f = _shard_map(two_arg, mesh, (P("dp"), P()),
                   P())
    return f(xs, ys)


def dynamic_specs(mesh, xs, ys, specs):
    f = _shard_map(two_arg, mesh, specs, P())
    return f(xs, ys)


def defaulted(mesh, xs):
    # 1 spec for (x, scale=1.0): within the required..total range
    f = _shard_map(with_default, mesh, (P("dp"),),
                   P())
    return f(xs)


def star_args(mesh, xs, ys):
    def v(*tensors):
        return sum(tensors)
    g = _shard_map(v, mesh, (P(), P(), P()),
                   P())
    return g(xs, ys, ys)


# --- the port's other sharded-call forms, matched ---

@sharded_jit(in_specs=(P("dp"), P()), out_specs=(P(), P()))
def decorated(x, y):
    return x, y


def late_bound(xs, ys):
    return sharded_jit(two_arg, in_specs=(P("dp"), P()),
                       out_specs=P())(xs, ys)


def placed(xs, ys):
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map

    one = local_map(two_arg, out_placements=[Shard(0)],    # one output
                    in_placements=([Shard(0)], [Shard(0)]))
    two = local_map(pair, out_placements=([Shard(0)], [Shard(0)]),
                    in_placements=([Shard(0)], [Shard(0)]))
    return one(xs, ys), two(xs, ys)
