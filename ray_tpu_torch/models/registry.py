"""Model registry: name -> (config presets, init/forward/loss fns).

Port of ``ray_tpu/models/registry.py``, mapping the four families to the
port's modules. Gives Train/Serve one switchboard:
    cfg, mod = registry.get("llama", "tiny")
"""

from __future__ import annotations

import importlib
from typing import Any, Tuple

_FAMILIES = {
    "llama": "ray_tpu_torch.models.llama",
    "gpt2": "ray_tpu_torch.models.gpt2",
    "moe": "ray_tpu_torch.models.moe",
    "vit": "ray_tpu_torch.models.vit",
}


def get(family: str, preset: str) -> Tuple[Any, Any]:
    """Returns (config, module). Module exposes init_params/forward/loss_fn/
    param_specs."""
    if family not in _FAMILIES:
        raise KeyError(f"unknown model family {family!r}; have {sorted(_FAMILIES)}")
    mod = importlib.import_module(_FAMILIES[family])
    presets = getattr(mod, "PRESETS")
    if preset not in presets:
        raise KeyError(f"unknown {family} preset {preset!r}; have {sorted(presets)}")
    return presets[preset], mod


def families():
    return sorted(_FAMILIES)
