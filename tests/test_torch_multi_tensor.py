"""The train step's multi-tensor passes (clg_vqa_tpu_torch/ops/multi_tensor.py)
on the CPU: the chunk table, the gradient buffers, the plain versions the
CPU runs, the reference chain's ``apply`` and the step's single global norm.
The CUDA kernels are held to these plain versions in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from clg_vqa_tpu_torch.config import UC2Config
from clg_vqa_tpu_torch.models.uc2 import UC2
from clg_vqa_tpu_torch.ops import multi_tensor as MT
from clg_vqa_tpu_torch.train import loop as tloop
from clg_vqa_tpu_torch.train import optim as topt

C = MT.CHUNK


@pytest.mark.parametrize("numels", [
    [1], [C], [C - 1, C + 1], [0, 3, 0], [2 * C + 5, 1, 7, 0, C],
    [250002 * 8, 768, 1, 13 * 5, 4097]])
def test_chunk_table_covers_every_element_once(numels):
    chunks, first = MT.chunk_table(numels)
    assert chunks.dtype == first.dtype == np.int64
    assert first[0] == 0 and first[-1] == len(chunks)
    seen = [np.zeros(n, np.int64) for n in numels]
    for c, (t, off) in enumerate(chunks):
        assert first[t] <= c < first[t + 1]
        length = min(C, numels[t] - off)
        assert 0 < length <= C and off % C == 0
        seen[t][off:off + length] += 1
    assert all((s == 1).all() for s in seen)
    # tensor by tensor, in order
    assert (np.diff(chunks[:, 0]) >= 0).all()


def test_grad_buffers_views_are_aligned_and_disjoint():
    like = [torch.empty(s) for s in [(1,), (7,), (3, 5), (0,), (4, 4), (9,)]]
    buf = MT.GradBuffers(like)
    assert [v.shape for v in buf.views] == [t.shape for t in like]
    starts = [v.storage_offset() for v in buf.views]
    assert all(s % MT.ALIGN == 0 for s in starts)
    for i, v in enumerate(buf.views):
        v.fill_(i + 1)
    for i, v in enumerate(buf.views):
        assert (v == i + 1).all()
    assert buf.flat.numel() == sum(-(-t.numel() // MT.ALIGN) * MT.ALIGN
                                   for t in like)
    assert buf.fits(like) and not buf.fits(like[:-1])
    assert not buf.fits(like[:-1] + [torch.empty(10)])


def test_accumulate_reuses_the_buffers_as_fresh_zeros():
    """Over two steps of 1-3 microbatches, with None gradients, the
    buffers equal zeros_like + add_(g / acc) bit for bit: a step's first
    microbatch overwrites what the last step left."""
    g = torch.Generator().manual_seed(0)
    like = [torch.empty(s) for s in [(1,), (7,), (3, 5), (1023,)]]
    buf = MT.GradBuffers(like)
    for acc in (3, 1, 2):
        want = [torch.zeros_like(t) for t in like]
        for a in range(acc):
            gs = [None if (i + a) % 3 == 0 else
                  torch.randn(t.shape, generator=g) * 10 ** (i - 2)
                  for i, t in enumerate(like)]
            MT.accumulate(buf, gs, first=a == 0, n=acc)
            for w, gi in zip(want, gs):
                if gi is not None:
                    w.add_(gi / acc)
        assert all(torch.equal(v, w) for v, w in zip(buf.views, want))


def _chain_world(seed: int, scale: float):
    g = torch.Generator().manual_seed(seed)
    shapes = {"a.weight": (6, 5), "a.bias": (5,), "ln.weight": (5,),
              "ln.bias": (5,), "b.weight": (3, 7), "c.bias": (1,)}
    params = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    grads = [{k: torch.randn(s, generator=g) * scale for k, s in shapes.items()}
             for _ in range(3)]
    mask = {k: ((torch.rand(s, generator=g) > 0.4).float()
                if k.endswith("weight") else None) for k, s in shapes.items()}
    return params, grads, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("scale", [0.01, 1.0])       # clip idle / engaged
def test_apply_plain_twin_equals_update_and_masked_add(masked, scale):
    params, grads, mask = _chain_world(1, scale)
    mask = mask if masked else None
    opt = topt.make_optimizer(list(params), 1e-2, weight_decay=0.01)
    mine = {k: p.clone() for k, p in params.items()}
    ref = {k: p.clone() for k, p in params.items()}
    s_mine, s_ref = opt.init(mine), opt.init(ref)
    for gs in grads:
        masked_g = {k: g if mask is None or mask[k] is None else g * mask[k]
                    for k, g in gs.items()}
        norm = topt.global_norm(masked_g.values())
        assert torch.equal(norm, topt.global_norm(
            gs.values(), None if mask is None else list(mask.values())))
        s_mine = opt.apply(gs, s_mine, mine, norm=norm, mask=mask)
        updates, s_ref = opt.update(masked_g, s_ref, ref)
        for k, p in ref.items():
            u = updates[k]
            if mask is not None and mask[k] is not None:
                u = u * mask[k]
            p.add_(u)
    assert s_mine.count == s_ref.count == len(grads)
    for k in params:
        assert torch.equal(mine[k], ref[k]), k
        assert torch.equal(s_mine.mu[k], s_ref.mu[k]), k
        assert torch.equal(s_mine.nu[k], s_ref.nu[k]), k
        if mask is not None and mask[k] is not None:
            assert torch.equal(mine[k][mask[k] == 0], params[k][mask[k] == 0])


def test_one_device_step_computes_the_norm_once(monkeypatch):
    """The step's norm is computed once, and the clip and
    ``metrics["grad_norm"]`` get that one tensor."""
    norms, clipped = [], []
    plain = MT.norm_plain

    def counting(*a, **kw):
        norms.append(plain(*a, **kw))
        return norms[-1]

    clip = topt.clip_by_global_norm

    def recording(grads, max_norm, norm=None):
        clipped.append(norm)
        return clip(grads, max_norm, norm)

    monkeypatch.setattr(MT, "norm_plain", counting)
    monkeypatch.setattr(topt, "clip_by_global_norm", recording)
    cfg = UC2Config(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                    intermediate_size=64, v_feature_size=16, num_locs=7,
                    pooler_size=32, clf_hidden_size=32, num_labels=8)
    model = UC2(cfg, device="cpu", seed=0)
    params = dict(model.named_parameters())
    opt = topt.make_optimizer(list(params), 1e-3)
    step = tloop.make_train_step(
        opt, torch.rand(8, 8), semantic_lambda=10.0, top_k=4,
        compute_dtype=None, grad_mask=topt.freeze_mask(params, ["pooler"]))
    r = np.random.RandomState(0)
    batch = {"input_ids": torch.from_numpy(r.randint(3, 64, (2, 3, 6))),
             "input_mask": torch.ones(2, 3, 6, dtype=torch.int32),
             "features": torch.from_numpy(r.randn(2, 3, 4, 16).astype(np.float32)),
             "locs": torch.from_numpy(r.rand(2, 3, 4, 7).astype(np.float32)),
             "image_mask": torch.ones(2, 3, 4, dtype=torch.int32),
             "labels": torch.from_numpy(r.randint(0, 8, (2, 3)))}
    state = tloop.TrainState(model, opt.init(params), 0)
    for i in range(2):
        norms.clear()
        clipped.clear()
        state, m = step(state, batch, seed=i)
        assert len(norms) == 1 and len(clipped) == 1
        assert m["grad_norm"] is norms[0] and clipped[0] is norms[0]


def test_adamw_kernel_entry_has_no_cpu_mode():
    p = [torch.zeros(3)]
    with pytest.raises(ValueError, match="unsupported device"):
        MT.adamw(p, p, p, p, None, [True], norm=torch.ones(()), b1=0.9,
                 b2=0.999, eps=1e-6, step=1e-3, decay=1e-5, max_norm=1.0)
