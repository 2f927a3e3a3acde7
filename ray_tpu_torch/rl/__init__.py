"""ray_tpu_torch.rl: reinforcement learning — a learner on the card, CPU
rollout actors.

Port of ``ray_tpu/rl`` (reference: rllib/ — Algorithm
(algorithms/algorithm.py:813 step, :1400 training_step) over a WorkerSet
of RolloutWorker actors (evaluation/worker_set.py, rollout_worker.py) and
the new API stack's Learner/LearnerGroup (core/learner/
learner_group.py:61)). BASELINE.md's config 5: env sampling stays on CPU
actor fleets (``core.CPU_WORKER_ENV`` hides the card from them); the
policy update runs on the learner's device, CUDA unless a config says
``device="cpu"``.

    from ray_tpu_torch.rl import PPOConfig, PPOTrainer

    trainer = PPOTrainer(PPOConfig(env="CartPole-v1", num_rollout_workers=2))
    for _ in range(10):
        metrics = trainer.train()

Ported: the core, connectors, the pixel env, the Nature CNN, PPO, the
Learner API and the on-policy family built on PPO's worker and policy
(PG, A2C, A3C, IMPALA, APPO, DDPPO, multi-agent PPO, the policy server).
The reference's other algorithms are still to port (ROADMAP.md queue 1,
item 10): ``get_algorithm`` raises NotImplementedError for them.
"""

from ray_tpu_torch.rl.a2c import A2CConfig, A2CTrainer
from ray_tpu_torch.rl.a3c import A3CConfig, A3CTrainer
from ray_tpu_torch.rl.appo import APPOConfig, APPOTrainer
from ray_tpu_torch.rl.connectors import (ClipObs, Connector,
                                         ConnectorPipeline, FlattenObs,
                                         FrameStack, NormalizeObs)
from ray_tpu_torch.rl.core import (Algorithm, ReplayActor, ReplayBuffer,
                                   params_from_jax)
from ray_tpu_torch.rl.ddppo import DDPPOConfig, DDPPOTrainer
from ray_tpu_torch.rl.impala import ImpalaConfig, ImpalaTrainer
from ray_tpu_torch.rl.learner import Learner, LearnerGroup, LearnerSpec
from ray_tpu_torch.rl.multi_agent import (MultiAgentEnv, MultiAgentPPOConfig,
                                          MultiAgentPPOTrainer,
                                          register_multi_agent_env)
from ray_tpu_torch.rl.pg import PGConfig, PGTrainer
from ray_tpu_torch.rl.policy_server import (ExternalPPOConfig,
                                            ExternalPPOTrainer, PolicyClient,
                                            PolicyServer)
from ray_tpu_torch.rl.ppo import PPOConfig, PPOTrainer

_REGISTRY = {
    "PPO": (PPOConfig, PPOTrainer),
    "IMPALA": (ImpalaConfig, ImpalaTrainer),
    "A2C": (A2CConfig, A2CTrainer),
    "MultiAgentPPO": (MultiAgentPPOConfig, MultiAgentPPOTrainer),
    "APPO": (APPOConfig, APPOTrainer),
    "PG": (PGConfig, PGTrainer),
    "A3C": (A3CConfig, A3CTrainer),
    "DDPPO": (DDPPOConfig, DDPPOTrainer),
}

# the reference's registered algorithms that are not ported yet
_NOT_PORTED = ("DQN", "SAC", "TD3", "BC", "CQL", "ApexDQN", "DDPG", "ES",
               "ARS", "BanditLinUCB", "BanditLinTS", "MARWIL", "SimpleQ",
               "RandomAgent", "R2D2", "CRR", "ApexDDPG", "QMIX", "MADDPG",
               "DT", "AlphaZero", "MAML", "SlateQ")


def get_algorithm(name: str):
    """(ConfigCls, TrainerCls) by name (ref: rllib registry.py
    get_algorithm_class)."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported to ray_tpu_torch yet (ROADMAP.md queue "
            "1, item 10: the RL modules still to port); ray_tpu.rl has it")
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown algorithm {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


__all__ = [
    "Algorithm", "ReplayBuffer", "ReplayActor", "get_algorithm",
    "params_from_jax",
    "PPOConfig", "PPOTrainer", "ImpalaConfig", "ImpalaTrainer",
    "A2CConfig", "A2CTrainer",
    "MultiAgentEnv", "MultiAgentPPOConfig", "MultiAgentPPOTrainer",
    "register_multi_agent_env",
    "PGConfig", "PGTrainer", "A3CConfig", "A3CTrainer",
    "DDPPOConfig", "DDPPOTrainer",
    "Learner", "LearnerGroup", "LearnerSpec",
    "Connector", "ConnectorPipeline", "NormalizeObs", "FrameStack",
    "FlattenObs", "ClipObs",
    "PolicyServer", "PolicyClient", "ExternalPPOConfig",
    "ExternalPPOTrainer",
    "APPOConfig", "APPOTrainer",
]
