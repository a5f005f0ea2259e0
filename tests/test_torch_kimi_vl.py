"""Kimi-VL-A3B's decoder on the port (models/kimi_vl.py, ops/moe.py's plain
products) against the benchmark's plain reference
(portbench/reference/kimi_vl.py) on seeded random weights, at the family's
tiny configuration (portbench/families/kimi_vl.tiny: width 64, two heads,
four of eight router experts held, top-3, one dense and two expert
layers), on the CPU.

Tolerances: fp32 logits within 2e-5 of the reference's (both sum the same
products in another order); step-1 gradients of every leaf within 1e-4 of
the reference leaf's norm (the loss is num_labels x the cross entropy, so
gradients are O(1)). The expert-parallel share is exact up to fp32
summation order (1e-5)."""
import json
import os
import pickle
import types

import numpy as np
import pytest
import torch

from clg_vqa_tpu_torch.cli import common as C
from clg_vqa_tpu_torch.config import KimiVLConfig
from clg_vqa_tpu_torch.models.kimi_vl import KimiVL
from clg_vqa_tpu_torch.ops import moe
from clg_vqa_tpu_torch.ops.semantic_prior import gqa_train_loss
from portbench.harness import manifest
from portbench.harness import weights as W
from portbench.reference import kimi_vl as ref
from portbench.reference.train import gqa_loss

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAM = manifest.family(ROOT, "kimi_vl")
with open(os.path.join(ROOT, "portbench", "configs", "kimi_vl_a3b.json")) as _f:
    CFG = json.load(_f)
CPU = torch.device("cpu")


def _tiny(tmp_path, **over):
    cfg = dict(FAM.tiny(CFG), **over)
    path = tmp_path / "kimi_tiny.json"
    path.write_text(json.dumps(cfg))
    return cfg, str(path)


def _batch(d, B=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    T, R = d["text"], d["regions"]
    b = dict(input_ids=torch.randint(3, d["vocab"], (B, T), generator=g),
             input_mask=torch.ones(B, T, dtype=torch.long),
             features=torch.randn(B, R, d["feat"], generator=g),
             locs=torch.rand(B, R, d["locs"], generator=g),
             image_mask=torch.ones(B, R, dtype=torch.long),
             labels=torch.randint(0, d["labels"], (B,), generator=g))
    b["input_mask"][1, 7:] = 0          # a short question
    b["input_ids"][1, 7:] = 1
    b["image_mask"][2, 3:] = 0          # an image of three boxes
    b["features"][2, 3:] = 0
    return b


def _program_and_weights(cfg, path, seed=3, bias=True):
    """The port's model and the reference's weights, with a nonzero
    selection bias in every expert layer (both sides)."""
    d = FAM.dims(cfg)
    w = W.make_weights(FAM.layout(d), d, seed, CPU)
    m = FAM.model(path, d, w, CPU)
    biases = {}
    if bias:
        g = torch.Generator().manual_seed(seed + 100)
        for i, layer in enumerate(m.layers):
            if i >= d["dense"]:
                b = 0.3 * torch.randn(d["router"], generator=g)
                layer.ffn.router.selection_bias.copy_(b)
                biases[str(i)] = b.tolist()
    return m, w, dict(cfg, selection_bias=biases), d


@pytest.mark.parametrize("seed", [None, 11])
def test_logits_match_the_reference(tmp_path, seed):
    cfg, path = _tiny(tmp_path)
    m, w, rcfg, d = _program_and_weights(cfg, path)
    b = _batch(d)
    got = m(b, deterministic=seed is None, seed=seed)
    want = ref.forward(rcfg, w, b, seed=seed)
    assert got.shape == (5, d["labels"])
    assert torch.allclose(got, want, rtol=0, atol=2e-5), (got - want).abs().max()


def test_the_selection_bias_changes_the_choice(tmp_path):
    """The bias chooses: the program with its bias equals the reference
    given the same bias, and differs from the reference without it."""
    cfg, path = _tiny(tmp_path)
    m, w, rcfg, d = _program_and_weights(cfg, path)
    b = _batch(d)
    got = m(b)
    assert torch.allclose(got, ref.forward(rcfg, w, b), atol=2e-5)
    assert not torch.allclose(got, ref.forward(cfg, w, b), atol=1e-3)


def test_step1_gradients_match_the_reference(tmp_path):
    cfg, path = _tiny(tmp_path)
    m, w, rcfg, d = _program_and_weights(cfg, path)
    b = _batch(d)
    D = W.make_distance(d["labels"], 4, CPU)
    logits = m(b, deterministic=False, seed=5)
    loss = gqa_train_loss(logits, b["labels"], D, semantic_lambda=10.0, top_k=10,
                          num_labels=d["labels"])
    names = [n for n, _ in m.named_parameters()]
    got = dict(zip(names, torch.autograd.grad(loss, list(m.parameters()))))
    wr = {k: v.clone().requires_grad_() for k, v in w.items()}
    rl = ref.forward(rcfg, wr, b, seed=5)
    rloss = gqa_loss(rl, b["labels"], D, lam=10.0, top_k=10, num_labels=d["labels"])
    assert abs(loss.item() - rloss.item()) <= 1e-5 * abs(rloss.item())
    want = dict(zip(wr, torch.autograd.grad(rloss, list(wr.values()))))
    assert set(got) == set(want)
    for k in want:
        scale = max(want[k].norm().item(), 1e-3)
        assert (got[k] - want[k]).norm().item() <= 1e-4 * scale, k
    # every expert layer's held experts were trained by some token
    for i in range(d["dense"], d["layers"]):
        assert got[f"layers.{i}.ffn.experts.w1"].abs().sum() > 0


def test_bf16_forward_stays_near_the_reference(tmp_path):
    cfg, path = _tiny(tmp_path)
    m, w, rcfg, d = _program_and_weights(cfg, path)
    b = _batch(d)
    got = m(b, compute_dtype=torch.bfloat16).float()
    want = ref.forward(rcfg, w, b)
    assert (got - want).abs().max() <= 0.05 * want.abs().max()


def test_the_expert_shares_add_up_to_the_uncut_layer():
    """Over the 8 shares of a 64-expert layer, the program's routed parts
    (ops/moe.routed_experts, each share holding 8 experts) plus the shared
    experts counted once equal the reference's uncut layer (all 64 held);
    the reference's own shares add up to it too."""
    d = FAM.dims(FAM.tiny(CFG))
    d.update(router=64, held=64, first=0, topk=6)
    H, I = d["H"], d["moe_ffn"]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(40, H, generator=g)
    w = {"f.router.weight": 0.3 * torch.randn(64, H, generator=g),
         "f.experts.w1": 0.1 * torch.randn(64, 2 * I, H, generator=g),
         "f.experts.w2": 0.1 * torch.randn(64, H, I, generator=g),
         "f.shared.gate.weight": 0.1 * torch.randn(I, H, generator=g),
         "f.shared.up.weight": 0.1 * torch.randn(I, H, generator=g),
         "f.shared.down.weight": 0.1 * torch.randn(H, I, generator=g)}
    bias = 0.2 * torch.randn(64, generator=g)
    whole = ref.expert_layer(x, w, "f", d, bias, ref.FP32)
    shared = ref.swiglu_mlp(x, w["f.shared.gate.weight"], w["f.shared.up.weight"],
                            w["f.shared.down.weight"], ref.FP32)
    idx, wts = moe.route(x @ w["f.router.weight"].t(), bias, 6, d["scale"])
    program, reference = shared.clone(), shared.clone()
    for r in range(8):
        sl = slice(8 * r, 8 * r + 8)
        disp = moe.dispatch(idx, 8 * r, 8)
        program += moe.routed_experts(x, wts, w["f.experts.w1"][sl].contiguous(),
                                      w["f.experts.w2"][sl].contiguous(), disp)
        share = dict(w, **{"f.experts.w1": w["f.experts.w1"][sl],
                           "f.experts.w2": w["f.experts.w2"][sl]})
        reference += ref.expert_layer(x, share, "f", dict(d, held=8, first=8 * r),
                                      bias, ref.FP32) - shared
    assert torch.allclose(program, whole, atol=1e-5), (program - whole).abs().max()
    assert torch.allclose(reference, whole, atol=1e-5)


def test_the_expert_counters_record_only_under_a_profiler(tmp_path):
    """``moe.pairs`` and ``moe.largest_group`` (utils/profiling.count): one
    reading an expert layer while a profiler records, the pairs routed to
    the held experts; none otherwise."""
    from clg_vqa_tpu_torch.utils import profiling
    cfg, path = _tiny(tmp_path)
    m, _, _, d = _program_and_weights(cfg, path, bias=False)
    b = _batch(d)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("train.step"):
            m(b)
    recs = profiling.counter_records()
    experts = d["layers"] - d["dense"]
    pairs = [int(c.values) for c in recs if c.name == "moe.pairs"]
    largest = [int(c.values) for c in recs if c.name == "moe.largest_group"]
    assert len(pairs) == len(largest) == experts
    tokens = b["input_ids"].shape[0] * (d["text"] + d["regions"])
    assert all(0 < p <= tokens * min(d["topk"], d["held"]) for p in pairs)
    assert all(0 < g <= p for g, p in zip(largest, pairs))
    m(b)
    assert len(profiling.counter_records()) == len(recs)


def test_dispatch_pads_each_expert_to_whole_tiles():
    g = torch.Generator().manual_seed(1)
    idx = torch.stack([torch.randperm(16, generator=g)[:4] for _ in range(300)])
    d = moe.dispatch(idx, 4, 6)
    counts = torch.stack([((idx >= 4 + e) & (idx < 5 + e)).sum() for e in range(6)])
    assert torch.equal(d.counts, counts)
    poff = d.poff.long()
    assert poff[0] == 0 and torch.all(poff % moe.TILE == 0)
    assert torch.equal(poff[1:] - poff[:-1], (counts + 127) // 128 * 128)
    assert d.rows == moe.buffer_rows(300, 4, 6) and poff[-1] <= d.rows
    held = d.dest[d.held.reshape(-1)]
    assert held.unique().numel() == held.numel() == int(counts.sum())
    assert torch.all(d.dest[~d.held.reshape(-1)] == d.rows)
    e = (idx - 4).reshape(-1)[d.held.reshape(-1)]
    assert torch.all((held >= poff[e]) & (held < poff[e] + counts[e]))
    pads = d.pad[d.pad < d.rows]
    assert pads.numel() == int((poff[1:] - poff[:-1] - counts).sum())
    assert not set(pads.tolist()) & set(held.tolist())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_routed_experts_gradients_match_the_per_token_loop(dtype):
    """The plain grouped products' forward and backward equal a loop over
    each token's held pairs (fp32: to rounding; bf16: the kernel's
    roundings, within bf16 tolerances), with an expert that takes no
    pair."""
    g = torch.Generator().manual_seed(2)
    T, H, I, E = 50, 32, 16, 4
    x = torch.randn(T, H, generator=g).to(dtype).requires_grad_()
    idx = torch.stack([torch.randperm(10, generator=g)[:3] for _ in range(T)])
    idx[idx == 5] = 9                    # expert 5 (held: 3..6) takes no pair
    wts = torch.rand(T, 3, generator=g).requires_grad_()
    w1 = (0.2 * torch.randn(E, 2 * I, H, generator=g)).requires_grad_()
    w2 = (0.2 * torch.randn(E, H, I, generator=g)).requires_grad_()
    d = moe.dispatch(idx, 3, E)
    out = moe.routed_experts(x, wts, w1, w2, d)
    cot = torch.randn(T, H, generator=g)
    got = torch.autograd.grad((out * cot).sum(), [x, wts, w1, w2])
    xf = x.detach().float().requires_grad_()
    wf = wts.detach().clone().requires_grad_()
    w1f, w2f = w1.detach().clone().requires_grad_(), w2.detach().clone().requires_grad_()
    want = torch.zeros(T, H)
    for t in range(T):
        for j in range(3):
            e = int(idx[t, j]) - 3
            if 0 <= e < E:
                a = xf[t] @ w1f[e].t().to(dtype).float()
                y = (torch.nn.functional.silu(a[:I]) * a[I:]) @ w2f[e].t().to(dtype).float()
                want = want.index_add(0, torch.tensor([t]), (wf[t, j] * y)[None])
    ref_g = torch.autograd.grad((want * cot).sum(), [xf, wf, w1f, w2f])
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    assert (out.float() - want).abs().max() <= tol * want.abs().max()
    assert got[2][2].abs().sum() == 0 and got[3][2].abs().sum() == 0
    for a, b in zip(got, ref_g):
        assert (a.float() - b).norm() <= tol * b.norm() + 1e-6


def test_the_configuration_is_the_stated_cut():
    d = FAM.dims(CFG)
    spec = FAM.layout(d)
    n = sum(int(np.prod(s)) for _, s, _ in spec)
    assert 1.24e9 < n < 1.25e9
    assert 59.5e9 < FAM.forward_flops(d) < 59.7e9
    assert FAM.held_picks(d) == 0.75
    c = KimiVLConfig.from_json(os.path.join(ROOT, "portbench", "configs",
                                            "kimi_vl_a3b.json"))
    assert (c.router_experts, c.held_experts, c.num_layers, c.first_dense) == (64, 8, 9, 1)
    assert (c.hidden_size, c.moe_intermediate_size, c.intermediate_size) == (2048, 1408, 11264)
    # every leaf is a trained parameter; the selection bias is a buffer
    m = KimiVL(KimiVLConfig(
        hidden_size=64, num_layers=2, num_heads=2, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        intermediate_size=96, moe_intermediate_size=128, router_experts=8,
        held_experts=4, experts_per_token=3, vocab_size=100,
        projector_hidden_size=64, clf_hidden_size=128), device="cpu")
    assert "layers.1.ffn.router.selection_bias" in m.state_dict()
    assert all("selection_bias" not in k for k, _ in m.named_parameters())


def _world(tmp_path, L=5, n_q=32):
    from clg_vqa_tpu_torch.data.cfs import CfsWriter
    from clg_vqa_tpu_torch.data.features import RegionRecord
    data = tmp_path / "annotations"
    data.mkdir()
    label2ans = [f"ans{k}" for k in range(L)]
    pickle.dump({a: i for i, a in enumerate(label2ans)},
                open(data / "trainval_ans2label.pkl", "wb"))
    pickle.dump(label2ans, open(data / "trainval_label2ans.pkl", "wb"))
    items = [{"question_id": i, "image_id": f"i{i % 4}",
              "question": f"marker{i % L} thing ?", "labels": [i % L],
              "scores": [1.0]} for i in range(n_q)]
    pickle.dump(items, open(data / "train_target.pkl", "wb"))
    pickle.dump(items[:8], open(data / "val_target.pkl", "wb"))
    json.dump({str(900 + i): {"imageId": f"i{i % 4}",
                              "question": f"marker{i % L} thing ?",
                              "answer": f"ans{i % L}"} for i in range(8)},
              open(data / "testdev_balanced_questions.json", "w"))
    r = np.random.RandomState(0)
    store = tmp_path / "f.cfs"
    with CfsWriter(str(store)) as w:
        for i in range(4):
            n = r.randint(3, 7)
            boxes = np.stack([r.rand(n) * 40, r.rand(n) * 40,
                              50 + r.rand(n) * 40, 50 + r.rand(n) * 40],
                             1).astype(np.float32)
            w.add(RegionRecord(f"i{i}", r.randn(n, 32).astype(np.float32),
                               boxes, 100.0, 100.0))
    (tmp_path / "task.yml").write_text(
        f"TASK15:\n  name: GQA\n  type: VL-classifier-GQA\n  num_labels: {L}\n"
        f"  loss: CrossEntropyLoss\n  dataroot: {data}\n"
        f"  features_h5path1: {store}\n  features_h5path2: {store}\n"
        "  max_seq_length: 8\n  max_region_num: 6\n  batch_size: 16\n"
        "  eval_batch_size: 8\n  train_split: train\n  val_split: val\n"
        "  lr: 0.005\n  num_epoch: 1\n  semantic_lambda: 1\n"
        "  semantic_dict_path: ''\n")
    return label2ans


def test_cli_train_eval_and_refusals(tmp_path):
    """``cli train`` builds Kimi-VL from a file whose model_name is kimi_vl
    and takes it through FinetuneRunner's step and the .bin export; ``cli
    eval`` runs it through run_eval; ``prune`` and ``sft`` refuse it."""
    from clg_vqa_tpu_torch.cli.__main__ import main
    label2ans = _world(tmp_path)
    cfg, path = _tiny(tmp_path, vocab_size=512, v_feature_size=32, num_labels=5)
    common = ["--config_file", path, "--tasks_config_file", str(tmp_path / "task.yml"),
              "--fp32", "--device", "cpu"]
    args = types.SimpleNamespace(tasks_config_file=str(tmp_path / "task.yml"),
                                 task="15", config_file=path, is_m3p=False,
                                 from_pretrained="", seed=0, device="cpu")
    mcfg, _, _ = C.build_configs(args)
    assert isinstance(mcfg, KimiVLConfig) and C.model_name(mcfg) == "kimi_vl"
    assert isinstance(C.build_model(args, mcfg), KimiVL)
    main(["train", *common, "--output_dir", str(tmp_path / "ft"),
          "--grad_acc_steps", "2"])
    meta = json.load(open(tmp_path / "ft" / "meta.json"))
    assert meta["step"] == 2
    main(["eval", *common, "--output_dir", str(tmp_path / "ev"), "--from_pretrained",
          str(tmp_path / "ft" / "params_best"), "--split", "test"])
    preds = json.load(open(tmp_path / "ev" / "test_result.json"))
    assert len(preds) == 8 and {p["prediction"] for p in preds} <= set(label2ans)
    for mode in ("prune", "sft"):
        extra = ["--mask_file", "none.npz"] if mode == "sft" else []
        with pytest.raises(ValueError, match="kimi_vl"):
            main([mode, *common, "--output_dir", str(tmp_path / mode), *extra])


def test_bin_export_round_trip(tmp_path):
    from clg_vqa_tpu_torch.train import checkpoints as ckpt
    from clg_vqa_tpu_torch.utils.convert import load_numpy_state
    cfg, path = _tiny(tmp_path)
    m, _, _, d = _program_and_weights(cfg, path)
    ckpt.export_torch_bin(str(tmp_path / "m.bin"), m, "kimi_vl")
    kcfg = KimiVLConfig.from_json(path)
    again = load_numpy_state(KimiVL(kcfg, device="cpu", seed=9),
                             C.load_pretrained(str(tmp_path / "m.bin"), kcfg))
    b = _batch(d)
    assert torch.equal(m(b), again(b))
