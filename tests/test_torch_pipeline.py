"""The port's TrainPipeline (clg_vqa_tpu_torch/data/pipeline.py) against the
JAX package's (clg_vqa_tpu/data/pipeline.py) over one dataset: the same epoch
order, host sharding and start_step cursor, bit-equal batches."""
import numpy as np
import pytest
import torch

from clg_vqa_tpu.data.pipeline import TrainPipeline as JPipeline
from clg_vqa_tpu_torch.data.pipeline import TrainPipeline
from clg_vqa_tpu_torch.data.synthetic import eval_world, train_dataset

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    w = eval_world(str(d), 4, num_labels=16, vocab_size=1000, n_images=6,
                   device="cpu")
    return train_dataset(w, 27, seed=3)


def _assert_same(got, want):
    assert len(got) == len(want) and len(got) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("with_features", [True, False])
@pytest.mark.parametrize("hosts", [(0, 1), (1, 2)])
def test_batches_match_jax_over_two_epochs(dataset, with_features, hosts):
    host_id, num_hosts = hosts
    kw = dict(micro_batch_size=2, grad_acc_steps=2, seed=5, host_id=host_id,
              num_hosts=num_hosts, with_features=with_features)
    mine = TrainPipeline(dataset, device_put=False, **kw)
    ref = JPipeline(dataset, device_put=False, **kw)
    assert mine.steps_per_epoch() == ref.steps_per_epoch()
    for epoch in (0, 1):
        _assert_same(list(mine.epoch(epoch)), list(ref.epoch(epoch)))
    _assert_same(list(mine.epoch(1, start_step=2)),
                 list(ref.epoch(1, start_step=2)))
    b = next(iter(mine.epoch(0)))
    assert b["input_ids"].shape == (2, 2, 40)
    assert ("store_idx" in b) != with_features


def test_device_put_yields_tensors(dataset):
    mine = TrainPipeline(dataset, micro_batch_size=3, grad_acc_steps=2,
                         device_put=True, device="cpu", with_features=False)
    ref = TrainPipeline(dataset, micro_batch_size=3, grad_acc_steps=2,
                        device_put=False, with_features=False)
    got = list(mine.epoch(0))
    assert all(isinstance(v, torch.Tensor) for b in got for v in b.values())
    _assert_same([{k: v.numpy() for k, v in b.items()} for b in got],
                 list(ref.epoch(0)))


def test_assembly_failure_is_raised(dataset):
    class Broken:
        def __len__(self):
            return 8

        def make_batch(self, idx, with_features=True):
            raise KeyError("boom")

    pipe = TrainPipeline(Broken(), micro_batch_size=2, grad_acc_steps=1,
                         device_put=False)
    with pytest.raises(RuntimeError, match="assembly failed"):
        list(pipe.epoch(0))
