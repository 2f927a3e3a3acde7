"""TensorflowTrainer: TF_CONFIG MultiWorkerMirrored rendezvous over the
WorkerGroup (ref: python/ray/train/tensorflow/config.py:21,40 — the
backend exports TF_CONFIG from the gathered worker addresses; the user
loop builds tf.distribute.MultiWorkerMirroredStrategy unchanged, as in
python/ray/train/tests/test_tensorflow_trainer.py).

Port of tests/test_train_tensorflow.py, aimed at ray_tpu_torch."""

import json

import pytest

import ray_tpu_torch
from torch_runtime_support import reap_orphans  # noqa: F401


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def _tf_loop(config):
    import os

    import numpy as np

    from ray_tpu_torch.train import session

    # TF_CONFIG must be exported (full cluster spec, this rank's index)
    # BEFORE tensorflow initializes its cluster resolver
    tf_config = json.loads(os.environ["TF_CONFIG"])
    rank = session.world_rank()
    ws = session.world_size()
    assert tf_config["task"] == {"type": "worker", "index": rank}
    assert len(tf_config["cluster"]["worker"]) == ws

    import tensorflow as tf

    # forming the strategy IS the rendezvous: each worker starts its grpc
    # server on its TF_CONFIG address and blocks until the cluster is up
    strategy = tf.distribute.MultiWorkerMirroredStrategy()
    assert strategy.num_replicas_in_sync == ws

    # cross-worker collective proof: sum of (rank+1) over the cluster
    @tf.function
    def allreduce(v):
        def fn(x):
            ctx = tf.distribute.get_replica_context()
            # identity + rank>=1 tensors: a bare scalar constant folds to
            # a device-less value MWMS can't route ("destinations can
            # not be empty")
            return ctx.all_reduce(tf.distribute.ReduceOp.SUM,
                                  tf.identity(x))

        return strategy.run(fn, args=(v,))

    total = float(np.asarray(allreduce(tf.constant([float(rank + 1)])))[0])
    assert total == ws * (ws + 1) / 2, total

    # data-parallel training, canonical custom loop (keras 3 dropped
    # MWMS model.fit; the reference's TF loops predate that): grads
    # all-reduce across workers each step, identical updates keep the
    # local replicas in lockstep
    w = tf.Variable(tf.zeros((4, 1)))
    rng = np.random.default_rng(1234 + rank)      # per-rank data shard
    x = tf.constant(rng.normal(size=(64, 4)).astype("float32"))
    w_true = np.array([[1.0], [-2.0], [0.5], [0.0]], "float32")
    y = x @ tf.constant(w_true)

    @tf.function
    def train_step(x, y):
        def fn(x, y):
            with tf.GradientTape() as tape:
                loss = tf.reduce_mean(tf.square(tf.matmul(x, w) - y))
            g = tape.gradient(loss, w)
            ctx = tf.distribute.get_replica_context()
            g = ctx.all_reduce(tf.distribute.ReduceOp.MEAN,
                               tf.identity(g))
            w.assign_sub(0.3 * g)
            return loss

        return strategy.run(fn, args=(x, y))

    loss = None
    for step in range(config["steps"]):
        loss = float(train_step(x, y))
        session.report({"loss": loss, "step": step, "rank": rank})
    # replicas must agree bit-for-bit: allreduce(w)/ws == local w
    wsum = np.asarray(allreduce(w))
    assert np.allclose(wsum / ws, w.numpy()), "replicas diverged"
    assert loss < 1.0, loss
    return {"loss": loss, "w": w.numpy().ravel().tolist()}


@pytest.mark.slow
def test_tensorflow_trainer_multiworker(cluster, tmp_path):
    from ray_tpu_torch.train import (RunConfig, ScalingConfig,
                                     TensorflowTrainer)

    trainer = TensorflowTrainer(
        _tf_loop, train_loop_config={"steps": 30},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="tfmw", storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.ok, result.error
    assert result.metrics["loss"] < 5.0
