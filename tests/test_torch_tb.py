"""``tb_dir`` on the CPU: the port's ``MetricLogger`` writes the same
TensorBoard scalars as the JAX package's, and ``Config.validate`` refuses
``tb_dir`` where the ``tensorboard`` package is missing.

A file of its own: both writers import TensorFlow where it is installed
(``torch.utils.tensorboard`` through ``tensorboard``, the JAX
``MetricLogger`` through CLU), ~10 s, and under ``--dist loadfile`` a
file is one worker's.
"""

import os

import numpy as np
import pytest
import torch

from featurenet_tpu_torch.config import get_config
from featurenet_tpu_torch.train.loop import Trainer


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_tb_scalars_equal_the_jax_metric_logger(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    from featurenet_tpu.utils.logging import MetricLogger as JaxLogger
    from featurenet_tpu_torch.utils.logging import MetricLogger

    from tensorboard.util.tensor_util import make_ndarray

    def scalars(path):
        """Scalar summaries (torch's SummaryWriter) and scalar tensors
        (CLU's TF2 writer), as float32 values by tag."""
        acc = EventAccumulator(path)
        acc.Reload()
        out = {tag: [(s.step, s.value) for s in acc.Scalars(tag)]
               for tag in acc.Tags()["scalars"]}
        out.update({tag: [(s.step, float(np.float32(make_ndarray(s.tensor_proto))))
                          for s in acc.Tensors(tag)]
                    for tag in acc.Tags()["tensors"]})
        return out

    records = [(1, {"loss": 1.5, "accuracy": 0.25, "per_class": [0.5, 1.0]}),
               (2, {"loss": 1.25, "accuracy": 0.5}),
               (2, {"loss": 1.0, "count": 3})]
    got = {}
    for name, cls in (("port", MetricLogger), ("jax", JaxLogger)):
        with open(os.devnull, "w") as sink:
            lg = cls(stream=sink, tb_dir=str(tmp_path / name))
            for i, (step, m) in enumerate(records):
                lg.log(step, m, prefix="eval" if i == 2 else "train")
            lg.close()
        got[name] = scalars(str(tmp_path / name))
    assert got["port"] == got["jax"]
    assert set(got["port"]) == {"train/loss", "train/accuracy", "eval/loss",
                                "eval/count"}
    # The Trainer's logger writes the run's scalars to cfg.tb_dir.
    cfg = get_config("smoke16", tb_dir=str(tmp_path / "trainer"))
    with open(os.devnull, "w") as sink:
        t = Trainer(cfg, device="cpu", stream=sink)
        t.logger.log(5, {"loss": 2.0})
    t.logger.close()
    assert scalars(str(tmp_path / "trainer")) == {"train/loss": [(5, 2.0)]}


def test_tb_dir_is_refused_without_tensorboard(monkeypatch):
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "tensorboard"
                        else real(name, *a))
    with pytest.raises(ValueError, match="tensorboard"):
        get_config("smoke16", tb_dir="/tmp/tb")
    assert get_config("smoke16").tb_dir is None
