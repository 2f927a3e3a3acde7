"""Predictors + BatchPredictor: offline inference over Datasets.

Port of ``ray_tpu/train/predictor.py`` (reference: python/ray/train/
predictor.py, Predictor.from_checkpoint / predict, and
python/ray/train/batch_predictor.py). The JAX package's ``JaxPredictor``
(a jitted apply function) is ``FunctionPredictor`` here: it runs
``apply_fn(params, x)`` eagerly under ``torch.no_grad()`` on the params'
device. ``TorchPredictor`` and ``TransformersPredictor`` are copies.
``BatchPredictor.predict`` maps a predictor over a ``ray_tpu_torch.data``
Dataset's blocks with an actor pool, as the reference does; a replica
that should hold a card asks for it with
``resources_per_replica={"GPU": 1}``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Type

import numpy as np

from ray_tpu_torch.train.checkpoint import Checkpoint


class Predictor:
    """Base predictor; subclasses implement predict(batch)->batch."""

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kwargs) -> "Predictor":
        raise NotImplementedError

    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        raise NotImplementedError


def _first_tensor(tree):
    import torch
    from torch.utils import _pytree as pytree

    return next((x for x in pytree.tree_leaves(tree)
                 if isinstance(x, torch.Tensor)), None)


class FunctionPredictor(Predictor):
    """Wraps ``apply_fn(params, features) -> outputs`` over a param tree
    of tensors (the JAX package's ``JaxPredictor``, which jits it; here it
    runs eagerly, with no graph capture). Features go to the device of the
    params' first tensor (the CPU where there is none) and outputs come
    back as numpy."""

    def __init__(self, apply_fn: Callable, params: Any,
                 feature_column: str = "features",
                 output_column: str = "predictions"):
        self.params = params
        self.apply = apply_fn
        first = _first_tensor(params)
        self.device = first.device if first is not None else "cpu"
        self.feature_column = feature_column
        self.output_column = output_column

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, *,
                        apply_fn: Callable, device=None,
                        **kwargs) -> "FunctionPredictor":
        """The param tree saved under "params" (or the whole tree), placed
        on `device`: None means CUDA, as JAX's predictor computes on its
        default device, and raises without it; "cpu" only when asked."""
        import torch
        from torch.utils import _pytree as pytree

        import ray_tpu_torch

        dev = ray_tpu_torch.resolve_device(device)
        state = checkpoint.load_state()
        params = state.get("params", state) if isinstance(state, dict) \
            else state
        params = pytree.tree_map(
            lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t,
            params)
        return cls(apply_fn, params, **kwargs)

    def predict(self, batch):
        import torch

        x = torch.as_tensor(np.asarray(batch[self.feature_column]),
                            device=self.device)
        with torch.no_grad():
            out = self.apply(self.params, x)
        result = dict(batch)
        result[self.output_column] = (
            out.detach().cpu().numpy() if isinstance(out, torch.Tensor)
            else np.asarray(out))
        return result


class BatchPredictor:
    """Maps a predictor over a Dataset with a fleet of predictor actors
    (ref: batch_predictor.py:predict — actor pool over blocks)."""

    def __init__(self, checkpoint: Checkpoint,
                 predictor_cls: Type[Predictor], **predictor_kwargs):
        self.checkpoint = checkpoint
        self.predictor_cls = predictor_cls
        self.predictor_kwargs = predictor_kwargs

    def predict(self, dataset, *, num_replicas: int = 1,
                resources_per_replica: Optional[dict] = None,
                batch_size: Optional[int] = None):
        """Returns a new Dataset of prediction blocks."""
        import ray_tpu_torch
        from ray_tpu_torch.data.dataset import Dataset, _transform_block
        from ray_tpu_torch.util.actor_pool import ActorPool

        ckpt = self.checkpoint
        pred_cls = self.predictor_cls
        pred_kwargs = self.predictor_kwargs
        ops = dataset._ops

        @ray_tpu_torch.remote
        class _PredActor:
            def __init__(self):
                self.predictor = pred_cls.from_checkpoint(ckpt,
                                                          **pred_kwargs)

            def predict_block(self, idx, block):
                block = _transform_block(block, ops)
                return idx, self.predictor.predict(block)

        opts = {"resources": resources_per_replica} \
            if resources_per_replica else {}
        actors = [_PredActor.options(**opts).remote()
                  for _ in range(num_replicas)]
        pool = ActorPool(actors)
        for i, ref in enumerate(dataset._block_refs):
            pool.submit(lambda a, v: a.predict_block.remote(*v), (i, ref))
        results = []
        while pool.has_next():
            results.append(pool.get_next())
        for a in actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        # pool yields in completion order; restore block order
        results.sort(key=lambda ib: ib[0])
        return Dataset([ray_tpu_torch.put(b) for _, b in results], [])


class TorchPredictor(Predictor):
    """torch nn.Module predictor (ref: train/torch/torch_predictor.py) on
    the CPU, as in the reference; FunctionPredictor runs a function of a
    param tree on its device."""

    def __init__(self, model, feature_column: str = "features",
                 output_column: str = "predictions"):
        import torch

        self.model = model.eval()
        self.torch = torch
        self.feature_column = feature_column
        self.output_column = output_column

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, *, model=None,
                        **kwargs) -> "TorchPredictor":
        """`model` is the architecture; the checkpoint supplies a
        state_dict under "model" (or IS the state_dict). Non-array
        entries riding in the dict (epoch counters etc.) are ignored."""
        import torch

        if model is None:
            raise ValueError(
                "TorchPredictor.from_checkpoint needs model= (the "
                "architecture to load the checkpoint's state_dict into)")
        state = checkpoint.load_state()
        if isinstance(state, dict):
            sd = state.get("model", state)
            tensors = {k: torch.as_tensor(np.asarray(v))
                       for k, v in sd.items()
                       if hasattr(v, "shape") or torch.is_tensor(v)}
            if not tensors:
                raise ValueError(
                    f"checkpoint holds no array state for the model "
                    f"(keys: {list(sd)[:8]})")
            model.load_state_dict(tensors)
        return cls(model, **kwargs)

    def predict(self, batch):
        import torch

        x = torch.as_tensor(np.asarray(batch[self.feature_column]))
        with torch.no_grad():
            out = self.model(x)
        result = dict(batch)
        result[self.output_column] = out.numpy()
        return result


class TransformersPredictor(Predictor):
    """HF pipeline predictor (ref:
    train/huggingface/transformers_predictor.py — wraps a transformers
    pipeline over text batches)."""

    def __init__(self, pipeline, feature_column: str = "text",
                 output_column: str = "predictions"):
        self.pipeline = pipeline
        self.feature_column = feature_column
        self.output_column = output_column

    @classmethod
    def from_pretrained(cls, task: str, model: str,
                        **kwargs) -> "TransformersPredictor":
        from transformers import pipeline as hf_pipeline

        return cls(hf_pipeline(task, model=model, device=-1), **kwargs)

    def predict(self, batch):
        texts = [str(t) for t in batch[self.feature_column]]
        out = self.pipeline(texts)
        result = dict(batch)
        result[self.output_column] = np.asarray(
            [o.get("label", o) if isinstance(o, dict) else o
             for o in out], dtype=object)
        return result
