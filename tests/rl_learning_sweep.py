"""The learning check of ``test_multi_agent_ppo_learns`` over several seeds,
in both packages.

The check (tests/test_rl_multi_agent.py and its port in
tests/test_torch_rl_multi_agent.py): 8 ``train()`` iterations of
MultiAgentPPOTrainer on context_match (2 rollout workers x 128 steps,
minibatch 64, lr 1e-2), then finite losses, the greedy actions a=2 and
b=1 for the one-hot contexts 2 and 1, and an episode return mean above 25.
Four arms, each from `seed`:

- ``jax``: the JAX package's trainer from its own init, in this process
  through test_torch_support's stubs (the rollout workers run in local
  mode: the same numpy streams as actors give);
- ``port``: the port's trainer from its own init (``torch.Generator``);
- ``port_carried``: the port's trainer from the JAX trainer's init;
- ``jax_from_port``: the JAX trainer from the port's init.

The two carried arms tell the trainers from their inits' draws: a seed
whose check passes or fails with the init it starts from, in both
trainers, fails on the draw, not on the trainer.

Run from the repo root:

    JAX_PLATFORMS=cpu python tests/rl_learning_sweep.py --seeds 10

One JSON line per run, then the passes of each arm.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

ITERS = 8
CFG = dict(num_rollout_workers=2, rollout_fragment_length=128,
           minibatch_size=64, lr=1e-2)
OBS = {"a": np.eye(4, dtype=np.float32)[2],
       "b": np.eye(4, dtype=np.float32)[1]}


def check(trainer) -> dict:
    r = None
    for _ in range(ITERS):
        r = trainer.train()
    acts = trainer.compute_actions(OBS)
    out = {"finite": all(bool(np.isfinite(a["total_loss"]))
                         for a in r["policies"].values()),
           "acts": {k: int(v) for k, v in acts.items()},
           "return": float(r["episode_return_mean"])}
    out["ok"] = (out["finite"] and out["acts"] == {"a": 2, "b": 1}
                 and out["return"] > 25)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=10)
    args = ap.parse_args(argv)

    from test_torch_support import jax_reference

    import ray_tpu_torch
    from ray_tpu_torch.rl import core as tcore
    from ray_tpu_torch.rl import multi_agent as tma

    passes = {"jax": 0, "port": 0, "port_carried": 0, "jax_from_port": 0}
    ray_tpu_torch.init(num_cpus=4)
    try:
        for seed in range(args.seeds):
            res = {}
            with jax_reference() as ref:
                m = ref.rl_multi_agent
                rtr = m.MultiAgentPPOTrainer(
                    m.MultiAgentPPOConfig(seed=seed, **CFG))
                p0 = dict(rtr.policies)
                res["jax"] = check(rtr)
            for arm in ("port", "port_carried"):
                tr = tma.MultiAgentPPOTrainer(tma.MultiAgentPPOConfig(
                    seed=seed, device="cpu", **CFG))
                try:
                    if arm == "port":
                        t0 = {pid: tcore.to_host(p)
                              for pid, p in tr.policies.items()}
                    else:
                        tr.set_weights({pid: tcore.params_from_jax(p, "cpu")
                                        for pid, p in p0.items()})
                    res[arm] = check(tr)
                finally:
                    tr.stop()
            with jax_reference() as ref:
                import jax.numpy as jnp

                m = ref.rl_multi_agent
                rtr = m.MultiAgentPPOTrainer(
                    m.MultiAgentPPOConfig(seed=seed, **CFG))
                rtr.set_weights({pid: tcore.tree_map(
                    lambda t: jnp.asarray(t.numpy()), p)
                    for pid, p in t0.items()})
                res["jax_from_port"] = check(rtr)
            for arm, out in res.items():
                passes[arm] += out["ok"]
                print(json.dumps({"seed": seed, "arm": arm, **out}),
                      flush=True)
    finally:
        ray_tpu_torch.shutdown()
    print(json.dumps({"seeds": args.seeds, "passes": passes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
