"""Vision (CNN) policy network for pixel observations.

Port of ``ray_tpu/rl/vision.py`` (reference: rllib/models/torch/
visionnet.py:22, VisionNetwork with the Nature-DQN filters of
rllib/models/utils.py get_filter_config: 84x84 -> [32 8x8/4, 64 4x4/2,
64 3x3/1], then a dense layer of 512). The convolutions are ``F.conv2d``
and the dense layers matmuls: the reference leaves them to XLA, outside
any Pallas kernel.

Layouts: observations arrive NHWC ([B, H, W, C] from the connectors, as in
the reference) and are permuted to NCHW on the device (a view: channels-
last strides, which cuDNN takes as they are); conv weights are OIHW (JAX's
are HWIO; ``core.params_from_jax`` permutes them). The last conv's output
is flattened in NHWC order, ``permute(0, 2, 3, 1).reshape(B, -1)``, so
``head.w`` ([oh * ow * 64, hidden]) is the reference's leaf unchanged;
NCHW order would scramble its rows.

The params dict carries a "conv" key, which is how
ppo.policy_forward dispatches between the MLP and this network — PPO,
IMPALA, APPO and DDPPO all route through that one entry point.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.rl.core import dense_init

# Nature-DQN filter config (ref: rllib/models/utils.py get_filter_config)
NATURE_FILTERS = ((32, (8, 8), 4), (64, (4, 4), 2), (64, (3, 3), 1))


def conv_out_hw(h: int, w: int,
                filters=NATURE_FILTERS) -> Tuple[int, int]:
    """Spatial dims after the conv stack (VALID padding)."""
    for _, (kh, kw), s in filters:
        h = (h - kh) // s + 1
        w = (w - kw) // s + 1
    return h, w


def init_vision_policy(gen: torch.Generator, obs_shape: Sequence[int],
                       n_actions: int, hidden: int = 512,
                       filters=NATURE_FILTERS):
    """obs_shape: (H, W, C) AFTER the connector pipeline (e.g. 84x84x4
    for grayscale frame-stack). Returns a params dict (CPU tensors drawn
    from `gen`) compatible with ppo.policy_forward's dispatch."""
    H, W, C = obs_shape
    conv = []
    cin = C
    # strides stay OUT of the params tree (static config, not a
    # differentiable leaf); vision_forward reads them from `filters`
    for cout, (kh, kw), _stride in filters:
        fan_in = kh * kw * cin
        conv.append({
            "w": torch.randn((cout, cin, kh, kw), generator=gen)
            * (2.0 / fan_in) ** 0.5,
            "b": torch.zeros((cout,)),
        })
        cin = cout
    oh, ow = conv_out_hw(H, W, filters)
    if oh <= 0 or ow <= 0:
        raise ValueError(
            f"obs {tuple(obs_shape)} too small for the conv stack "
            f"(got {oh}x{ow} after convs); resize up or shrink filters")
    return {
        "conv": conv,
        "head": dense_init(gen, oh * ow * cin, hidden),
        # small-init pi head: near-uniform initial policy (standard for
        # pixel PPO; large initial logits collapse exploration)
        "pi": dense_init(gen, hidden, n_actions, scale=0.01),
        "v": dense_init(gen, hidden, 1),
    }


def vision_forward(params, obs, filters=NATURE_FILTERS):
    """obs [B, H, W, C] float (already scaled by the connector pipeline)
    -> (logits [B, A], value [B]). `filters` must match the config the
    params were initialized with (strides are static, not params)."""
    x = obs.permute(0, 3, 1, 2)
    for layer, (_cout, _k, stride) in zip(params["conv"], filters):
        x = F.relu(F.conv2d(x, layer["w"], layer["b"], stride=stride))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ params["head"]["w"] + params["head"]["b"])
    logits = x @ params["pi"]["w"] + params["pi"]["b"]
    value = (x @ params["v"]["w"] + params["v"]["b"])[..., 0]
    return logits, value
