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
(PG, A2C, A3C, IMPALA, APPO, DDPPO, multi-agent PPO, the policy server);
the replay-based off-policy family (DQN, SimpleQ, RandomAgent, R2D2, TD3,
DDPG, Ape-X DQN/DDPG, SAC), the offline family (BC, CQL, CRR, MARWIL, DT)
and the gradient-free algorithms (ES, ARS, the LinUCB/LinTS bandits; numpy
on the host, as in the reference); the cooperative multi-agent ones (QMIX
on ``TwoStepGame``, MADDPG on ``LineSpreadEnv``), meta-learning (MAML on
``PointGoalEnv``), planning (AlphaZero's MCTS self-play on ``TicTacToe``)
and slate recommendation (SlateQ on ``SlateRecEnv``). Every one of the
reference's 31 registry names resolves through ``get_algorithm``.
"""

from ray_tpu_torch.rl.a2c import A2CConfig, A2CTrainer
from ray_tpu_torch.rl.alpha_zero import (AlphaZeroConfig, AlphaZeroTrainer,
                                         TicTacToe)
from ray_tpu_torch.rl.a3c import A3CConfig, A3CTrainer
from ray_tpu_torch.rl.apex import (ApexDDPGConfig, ApexDDPGTrainer,
                                   ApexDQNConfig, ApexDQNTrainer,
                                   PrioritizedReplayActor,
                                   PrioritizedReplayBuffer)
from ray_tpu_torch.rl.appo import APPOConfig, APPOTrainer
from ray_tpu_torch.rl.bandit import (BanditConfig, LinearDiscreteBanditEnv,
                                     LinTSTrainer, LinUCBTrainer)
from ray_tpu_torch.rl.connectors import (ClipObs, Connector,
                                         ConnectorPipeline, FlattenObs,
                                         FrameStack, NormalizeObs)
from ray_tpu_torch.rl.core import (Algorithm, ReplayActor, ReplayBuffer,
                                   params_from_jax)
from ray_tpu_torch.rl.ddpg import DDPGConfig, DDPGTrainer
from ray_tpu_torch.rl.ddppo import DDPPOConfig, DDPPOTrainer
from ray_tpu_torch.rl.dqn import DQNConfig, DQNTrainer
from ray_tpu_torch.rl.dt import DTConfig, DTTrainer
from ray_tpu_torch.rl.es import ARSConfig, ARSTrainer, ESConfig, ESTrainer
from ray_tpu_torch.rl.impala import ImpalaConfig, ImpalaTrainer
from ray_tpu_torch.rl.learner import Learner, LearnerGroup, LearnerSpec
from ray_tpu_torch.rl.maddpg import LineSpreadEnv, MADDPGConfig, MADDPGTrainer
from ray_tpu_torch.rl.maml import MAMLConfig, MAMLTrainer, PointGoalEnv
from ray_tpu_torch.rl.marwil import MARWILConfig, MARWILTrainer
from ray_tpu_torch.rl.multi_agent import (MultiAgentEnv, MultiAgentPPOConfig,
                                          MultiAgentPPOTrainer,
                                          register_multi_agent_env)
from ray_tpu_torch.rl.offline import (BCConfig, BCTrainer, CQLConfig,
                                      CQLTrainer, CRRConfig, CRRTrainer)
from ray_tpu_torch.rl.pg import PGConfig, PGTrainer
from ray_tpu_torch.rl.policy_server import (ExternalPPOConfig,
                                            ExternalPPOTrainer, PolicyClient,
                                            PolicyServer)
from ray_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
from ray_tpu_torch.rl.qmix import QMIXConfig, QMIXTrainer, TwoStepGame
from ray_tpu_torch.rl.r2d2 import R2D2Config, R2D2Trainer
from ray_tpu_torch.rl.sac import SACConfig, SACTrainer
from ray_tpu_torch.rl.simple_q import (RandomAgentConfig, RandomAgentTrainer,
                                       SimpleQConfig, SimpleQTrainer)
from ray_tpu_torch.rl.slateq import SlateQConfig, SlateQTrainer, SlateRecEnv
from ray_tpu_torch.rl.td3 import TD3Config, TD3Trainer

_REGISTRY = {
    "PPO": (PPOConfig, PPOTrainer),
    "DQN": (DQNConfig, DQNTrainer),
    "SAC": (SACConfig, SACTrainer),
    "IMPALA": (ImpalaConfig, ImpalaTrainer),
    "TD3": (TD3Config, TD3Trainer),
    "A2C": (A2CConfig, A2CTrainer),
    "BC": (BCConfig, BCTrainer),
    "CQL": (CQLConfig, CQLTrainer),
    "MultiAgentPPO": (MultiAgentPPOConfig, MultiAgentPPOTrainer),
    "APPO": (APPOConfig, APPOTrainer),
    "ApexDQN": (ApexDQNConfig, ApexDQNTrainer),
    "DDPG": (DDPGConfig, DDPGTrainer),
    "ES": (ESConfig, ESTrainer),
    "ARS": (ARSConfig, ARSTrainer),
    "BanditLinUCB": (BanditConfig, LinUCBTrainer),
    "BanditLinTS": (BanditConfig, LinTSTrainer),
    "PG": (PGConfig, PGTrainer),
    "A3C": (A3CConfig, A3CTrainer),
    "MARWIL": (MARWILConfig, MARWILTrainer),
    "SimpleQ": (SimpleQConfig, SimpleQTrainer),
    "RandomAgent": (RandomAgentConfig, RandomAgentTrainer),
    "R2D2": (R2D2Config, R2D2Trainer),
    "CRR": (CRRConfig, CRRTrainer),
    "ApexDDPG": (ApexDDPGConfig, ApexDDPGTrainer),
    "DDPPO": (DDPPOConfig, DDPPOTrainer),
    "QMIX": (QMIXConfig, QMIXTrainer),
    "MADDPG": (MADDPGConfig, MADDPGTrainer),
    "DT": (DTConfig, DTTrainer),
    "AlphaZero": (AlphaZeroConfig, AlphaZeroTrainer),
    "MAML": (MAMLConfig, MAMLTrainer),
    "SlateQ": (SlateQConfig, SlateQTrainer),
}

# the reference's registered algorithms that are not ported: none is left
_NOT_PORTED = ()


def get_algorithm(name: str):
    """(ConfigCls, TrainerCls) by name (ref: rllib registry.py
    get_algorithm_class)."""
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown algorithm {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


__all__ = [
    "Algorithm", "ReplayBuffer", "ReplayActor", "get_algorithm",
    "params_from_jax",
    "PPOConfig", "PPOTrainer", "DQNConfig", "DQNTrainer",
    "SACConfig", "SACTrainer", "ImpalaConfig", "ImpalaTrainer",
    "TD3Config", "TD3Trainer", "A2CConfig", "A2CTrainer",
    "BCConfig", "BCTrainer", "CQLConfig", "CQLTrainer",
    "MultiAgentEnv", "MultiAgentPPOConfig", "MultiAgentPPOTrainer",
    "register_multi_agent_env",
    "PGConfig", "PGTrainer", "A3CConfig", "A3CTrainer",
    "MARWILConfig", "MARWILTrainer",
    "SimpleQConfig", "SimpleQTrainer", "RandomAgentConfig",
    "RandomAgentTrainer", "R2D2Config", "R2D2Trainer",
    "CRRConfig", "CRRTrainer", "ApexDDPGConfig", "ApexDDPGTrainer",
    "DDPPOConfig", "DDPPOTrainer", "DTConfig", "DTTrainer",
    "Learner", "LearnerGroup", "LearnerSpec",
    "Connector", "ConnectorPipeline", "NormalizeObs", "FrameStack",
    "FlattenObs", "ClipObs",
    "PolicyServer", "PolicyClient", "ExternalPPOConfig",
    "ExternalPPOTrainer",
    "APPOConfig", "APPOTrainer", "DDPGConfig", "DDPGTrainer",
    "ApexDQNConfig", "ApexDQNTrainer", "PrioritizedReplayBuffer",
    "PrioritizedReplayActor",
    "ESConfig", "ESTrainer", "ARSConfig", "ARSTrainer",
    "BanditConfig", "LinUCBTrainer", "LinTSTrainer",
    "LinearDiscreteBanditEnv",
    "QMIXConfig", "QMIXTrainer", "TwoStepGame",
    "MADDPGConfig", "MADDPGTrainer", "LineSpreadEnv",
    "AlphaZeroConfig", "AlphaZeroTrainer", "TicTacToe",
    "MAMLConfig", "MAMLTrainer", "PointGoalEnv",
    "SlateQConfig", "SlateQTrainer", "SlateRecEnv",
]
