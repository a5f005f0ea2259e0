"""The port's X101-FPN extractor (``models/detector/extractor_x101.py``,
``fpn.py``, the ResNeXt half of ``resnet.py``, the legacy half of
``rpn.py``, RoIAlign in ``ops/roi.py``, the X101 converter) against the JAX
package on the same numpy inputs, with JAX's weights carried across through
``utils/convert_detector.load_c4_params``.

Shapes are small: images of at most 128 x 128 and a narrow X101Config
(groups 4 x width 4, a 32-channel FPN, 64 proposals a level, 10 boxes) at
depth 101, its BatchNorm scales damped so the softmax spreads.

Tolerances: layers in fp32 within rtol 1e-4 and 1e-5 of the largest
|value| (the frameworks sum convs in other orders); caffe anchors, level
assignment, box chunks and selection indices exact; legacy decode and clip
rtol 1e-6; RoIAlign rtol 1e-5; bf16 FPN and box head rtol 2e-2; the whole
extractor in fp32: object ids and box order exact, features, boxes and
confidences within rtol 1e-3 and 1e-3 of the largest |value|.
"""
import functools
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clg_vqa_tpu.models.detector import extractor_x101 as JX
from clg_vqa_tpu.models.detector import fpn as JF
from clg_vqa_tpu.models.detector import resnet as JR
from clg_vqa_tpu.models.detector import rpn as JP
from clg_vqa_tpu.ops import nms as JN
from clg_vqa_tpu.ops import roi as JROI
from clg_vqa_tpu.utils import convert_detector as JC
from clg_vqa_tpu_torch.models.detector import extractor_x101 as X
from clg_vqa_tpu_torch.models.detector import fpn as F
from clg_vqa_tpu_torch.models.detector import resnet as R
from clg_vqa_tpu_torch.models.detector import rpn as P
from clg_vqa_tpu_torch.ops import nms as TN
from clg_vqa_tpu_torch.ops import roi as TROI
from clg_vqa_tpu_torch.utils import convert_detector as CD

torch.set_num_threads(1)

NARROW = dict(groups=4, width_per_group=4, fpn_channels=32, num_boxes=10,
              pre_nms_topk=64, post_nms_topk=64, pad_h=128, pad_w=128, short=96,
              max_size=128)
FP32 = dict(NARROW, bf16=False)


def close(got, want, rtol=1e-4, atol=1e-5):
    want = np.asarray(jnp.asarray(want, jnp.float32) if isinstance(want, jax.Array)
                      else want, np.float64)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30))


def t(x, dtype=None):
    x = torch.from_numpy(np.array(x))
    return x if dtype is None else x.to(dtype)


def damped(jp, s: float = 0.35):
    """Every frozen-BN scale times s: random-init X101 saturates the softmax
    (every box one class); damped, the scores spread and the selection has
    real choices to make."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x * s if path[-1].key == "scale" else x, jp)


@pytest.fixture(scope="module")
def weights():
    """(JAX tree as numpy, the port's tree) of JAX's narrow random X101,
    BN damped."""
    jp = jax.tree.map(np.asarray, JX.init_x101_params(jax.random.key(0),
                                                      JX.X101Config(**NARROW)))
    jp = jax.tree.map(np.asarray, damped(jp))
    return jp, CD.load_c4_params(jp)


def rand_boxes(r, n, H, W):
    x1 = r.rand(n) * (W - 10)
    y1 = r.rand(n) * (H - 10)
    return np.stack([x1, y1, x1 + 1 + r.rand(n) * (W - x1 - 1),
                     y1 + 1 + r.rand(n) * (H - y1 - 1)], 1).astype(np.float32)


def image(seed, h, w):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# ResNeXt
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride,in1x1", [(1, False), (2, False), (2, True)])
def test_grouped_bottleneck_matches_jax(stride, in1x1):
    r = np.random.RandomState(0)
    p = JR._init_bottleneck(jax.random.key(0), 32, 16, 64, shortcut=True, groups=4)
    p = jax.tree.map(lambda x: r.randn(*x.shape).astype(np.float32), p)
    assert p["conv2"]["w"].shape == (3, 3, 4, 16)        # HWIO, cin / groups
    x = r.randn(2, 9, 11, 32).astype(np.float32)
    want = JR.bottleneck(jnp.asarray(x), p, stride=stride, stride_in_1x1=in1x1,
                         groups=4)
    tp = CD.load_c4_params(p)
    assert tp["conv2"]["w"].shape == (16, 4, 3, 3)       # OIHW, cin / groups
    close(R.bottleneck(t(x), tp, stride=stride, stride_in_1x1=in1x1, groups=4), want)


@pytest.mark.parametrize("hw", [(10, 10), (11, 13), (7, 8)])
def test_stem_with_torch_pool_matches_jax(weights, hw):
    jp, tp = weights
    x = np.random.RandomState(1).randn(1, *hw, 3).astype(np.float32) * 50
    want = JR.stem(jnp.asarray(x), jp["backbone"]["stem"], caffe_pool=False)
    got = R.stem(t(x), tp["backbone"]["stem"], caffe_pool=False)
    assert got.shape == want.shape
    close(got, want)


def test_backbone_stages_match_jax(weights):
    jp, tp = weights
    x = np.random.RandomState(2).randn(1, 64, 96, 3).astype(np.float32) * 50
    want = JR.backbone_stages(jnp.asarray(x), jp["backbone"], stride_in_1x1=False,
                              caffe_pool=False, groups=4)
    got = R.backbone_stages(t(x), tp["backbone"], stride_in_1x1=False,
                            caffe_pool=False, groups=4)
    assert [tuple(g.shape) for g in got] == [(1, 16, 24, 256), (1, 8, 12, 512),
                                             (1, 4, 6, 1024), (1, 2, 3, 2048)]
    for g, w in zip(got, want):
        close(g, w)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def shapes(tree):
    """{path: shape} of a JAX tree, conv weights as the port holds them
    (HWIO -> OIHW)."""
    return {k: tuple(np.asarray(v.shape)[[3, 2, 0, 1]]) if v.ndim == 4 else v.shape
            for k, v in leaves(tree)}


def test_init_backbone_x_has_jax_shapes():
    jp = JR.init_backbone_x(jax.random.key(0), groups=64, width_per_group=4)
    tp = R.init_backbone_x(torch.Generator().manual_seed(0), groups=64,
                           width_per_group=4)
    assert {k: tuple(v.shape) for k, v in leaves(tp)} == shapes(jp)
    assert tp["res5"][2]["conv2"]["w"].shape == (2048, 32, 3, 3)


# ---------------------------------------------------------------------------
# legacy RPN conventions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride,size,hw", [(4, 32, (200, 336)), (8, 64, (13, 7)),
                                            (16, 128, (50, 84)), (32, 256, (4, 4)),
                                            (64, 512, (13, 21))])
def test_caffe_anchors_are_jaxs_bits(stride, size, hw):
    got = P.generate_anchors_caffe(*hw, stride=stride, sizes=(size,))
    want = JP.generate_anchors_caffe(*hw, stride=stride, sizes=(size,))
    assert got.dtype == want.dtype and got.shape == (hw[0] * hw[1] * 3, 4)
    np.testing.assert_array_equal(got, want)


def test_legacy_decode_and_clip_match_jax():
    r = np.random.RandomState(3)
    anchors = JP.generate_anchors_caffe(6, 7, stride=16, sizes=(128,))
    deltas = (r.randn(len(anchors), 4) * 2).astype(np.float32)
    deltas[::5, 2:] = 9.0                                 # past the clamp
    want = JP.decode_boxes_legacy(jnp.asarray(anchors), jnp.asarray(deltas))
    got = P.decode_boxes_legacy(t(anchors), t(deltas))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
    want_c = JP.clip_boxes_legacy(want, jnp.int32(77), jnp.int32(101))
    got_c = P.clip_boxes_legacy(got, torch.tensor([[77]]), torch.tensor([[101]]))
    np.testing.assert_allclose(got_c[0].numpy(), np.asarray(want_c), rtol=1e-6,
                               atol=1e-5)
    assert float(got_c[..., 2].max()) == 100.0 and float(got_c[..., 3].max()) == 76.0


# ---------------------------------------------------------------------------
# RoIAlign
# ---------------------------------------------------------------------------

def edge_rois(r, H, W, stride):
    special = np.asarray([[-5 * stride, -5 * stride, (W + 5) * stride, (H + 5) * stride],
                          [3 * stride, 2 * stride, 3 * stride, 2 * stride],
                          [6 * stride, 6 * stride, 2 * stride, 1 * stride],
                          [(W - 1) * stride, (H - 1) * stride, (W + 3) * stride,
                           (H + 3) * stride]], np.float32)
    return np.concatenate([rand_boxes(r, 12, H * stride, W * stride), special])


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sampling_ratio", [1, 2])
def test_roi_align_matches_jax(aligned, sampling_ratio):
    r = np.random.RandomState(4)
    C, H, W = 5, 13, 17
    feat = r.randn(C, H, W).astype(np.float32)
    rois = edge_rois(r, H, W, 8)
    kw = dict(output_size=(7, 7), spatial_scale=1 / 8, sampling_ratio=sampling_ratio,
              aligned=aligned)
    want = JROI.roi_align(jnp.asarray(feat), jnp.asarray(rois), **kw)
    got = TROI.roi_align(t(feat), t(rois), **kw)
    assert got.shape == (len(rois), C, 7, 7) and got.dtype == torch.float32
    close(got, want, rtol=1e-5, atol=1e-5)


def pyramid(r, C, sizes):
    """[1, H, W, C] maps of P2..P5."""
    return [r.randn(1, h, w, C).astype(np.float32) for h, w in sizes]


def level_rois(r):
    """Random rois in a 128 x 128 image and some on each level, past the
    edges and degenerate."""
    rois = rand_boxes(r, 40, 128, 128)
    rois[:8] = [[0, 0, 20, 20], [0, 0, 112, 112], [4, 4, 126, 126],
                [-5, -5, 140, 140], [50, 50, 50, 50], [0, 0, 30, 226],
                [0, 0, 240, 240], [-10, 20, 500, 460]]
    return rois


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_align_flat_matches_jax(dtype):
    r = np.random.RandomState(5)
    maps = pyramid(r, 6, [(32, 32), (16, 16), (8, 8), (4, 4)])
    rois = level_rois(r)
    jmaps = [jnp.asarray(m, dtype) for m in maps]
    want = JF.multilevel_roi_align_flat(jmaps + [jmaps[-1]], jnp.asarray(rois),
                                        legacy_levels=True)
    tmaps = [t(m, getattr(torch, dtype)) for m in maps]
    got = F.multilevel_roi_align_flat(tmaps + [tmaps[-1]], t(rois), legacy_levels=True)
    assert got.dtype == torch.float32 and got.shape == (40, 6, 7, 7)
    close(got, want, rtol=1e-5, atol=1e-5)
    lv = F.assign_levels(t(rois), legacy=True)
    assert set(lv.tolist()) == {0, 1, 2, 3}


def test_multilevel_roi_align_matches_jax():
    r = np.random.RandomState(6)
    maps = pyramid(r, 4, [(32, 32), (16, 16), (8, 8), (4, 4)])
    rois = level_rois(r)
    want = JF.multilevel_roi_align([jnp.asarray(m) for m in maps], jnp.asarray(rois))
    got = F.multilevel_roi_align([t(m) for m in maps], t(rois))
    close(got, want, rtol=1e-5, atol=1e-5)
    flat = F.multilevel_roi_align_flat([t(m) for m in maps], t(rois))
    assert torch.equal(flat, got)


@pytest.mark.parametrize("n_rois,box_chunk", [(40, 8), (40, 7), (40, 100), (37, 8),
                                              (40, 0)])
def test_box_chunk_is_bit_identical(n_rois, box_chunk):
    """Chunks of the largest divisor <= box_chunk (40 -> 8, 7 -> 5; 37 is
    prime, so unchunked), each bit for bit the unchunked pass."""
    r = np.random.RandomState(7)
    maps = [t(m, torch.bfloat16) for m in pyramid(r, 6, [(32, 32), (16, 16),
                                                         (8, 8), (4, 4)])]
    rois = t(level_rois(r)[:n_rois])
    whole = F.multilevel_roi_align_flat(maps, rois, legacy_levels=True)
    got = F.multilevel_roi_align_flat(maps, rois, legacy_levels=True,
                                      box_chunk=box_chunk)
    assert torch.equal(got, whole)


@pytest.mark.parametrize("legacy", [True, False])
def test_assign_levels_equal_jax(legacy):
    r = np.random.RandomState(8)
    rois = np.concatenate([level_rois(r), rand_boxes(r, 200, 800, 1344)])
    want = JF.assign_levels(jnp.asarray(rois), legacy=legacy)
    got = F.assign_levels(t(rois), legacy=legacy)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# FPN, box head, selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fpn_matches_jax(weights, dtype):
    jp, tp = weights
    r = np.random.RandomState(9)
    feats = [r.randn(1, 16 // 2 ** i, 24 // 2 ** i, c).astype(np.float32)
             for i, c in enumerate((256, 512, 1024, 2048))]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = JF.fpn(tuple(jnp.asarray(f, jd) for f in feats),
                  jax.tree.map(lambda x: jnp.asarray(x, jd), jp["fpn"]))
    got = F.fpn(tuple(t(f, td) for f in feats),
                jax.tree.map(lambda x: x.to(td), tp["fpn"]))
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert got[4].shape == (1, 1, 2, 32) and got[0].dtype == td
    for g, w in zip(got, want):
        if dtype == "float32":
            close(g, w)
        else:
            close(g, w, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_box_head_fc_matches_jax(weights, dtype):
    jp, tp = weights
    crops = np.random.RandomState(10).randn(30, 32, 7, 7).astype(np.float32)
    want = JF.box_head_fc(jnp.asarray(crops), jp["box_head"],
                          compute_dtype=None if dtype is None else jnp.bfloat16)
    got = F.box_head_fc(t(crops), tp["box_head"],
                        compute_dtype=None if dtype is None else torch.bfloat16)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        if dtype is None:
            close(g, w)
        else:
            close(g, w, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("case", ["random", "ties_and_invalid"])
def test_select_top_by_class_nms_equals_jax(case):
    """"ties_and_invalid": duplicated boxes with duplicated score rows (tied
    priorities), boxes suppressed in every class and invalid ones, so more
    than num_keep boxes have max_conf 0 and fill the slots in index order."""
    r = np.random.RandomState(11)
    N, C = 48, 5
    boxes = rand_boxes(r, N, 120, 120)
    logits = r.randn(N, C + 1)
    valid = None
    if case == "ties_and_invalid":
        boxes[24:] = boxes[:24]
        logits[24:] = logits[:24]
        valid = r.rand(N) > 0.3
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    want = JF.select_top_by_class_nms(
        jnp.asarray(boxes), jnp.asarray(probs), num_keep=40, legacy=True,
        valid=None if valid is None else jnp.asarray(valid))
    got = F.select_top_by_class_nms(
        t(boxes), t(probs), num_keep=40, legacy=True,
        valid=None if valid is None else t(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "ties_and_invalid":
        assert int((got[1] == 0).sum()) >= 5


def test_fixpoint_over_stacked_images_equals_each_alone():
    """The RPN's NMS runs every image's five levels as one [5N, K] call:
    per-class IoU on [C, K, 4] boxes, each class its own fixpoint."""
    r = np.random.RandomState(12)
    boxes = np.stack([rand_boxes(r, 30, 90, 90) for _ in range(10)])
    scores = r.randn(10, 30).astype(np.float32)
    scores[:, ::7] = -np.inf
    valid = np.isfinite(scores)
    before = TN.batched_nms_fixpoint.host_syncs
    got = TN.batched_nms_fixpoint(t(boxes), t(scores), 0.7, valid=t(valid),
                                  class_chunk=8, legacy=True)
    assert TN.batched_nms_fixpoint.host_syncs > before + 1    # two chunks
    for c in range(10):
        alone = TN.batched_nms_fixpoint(t(boxes[c]), t(scores[c:c + 1]), 0.7,
                                        valid=t(valid[c]), legacy=True)
        assert torch.equal(got[c], alone[0])
    want = JN.batched_nms_fixpoint(jnp.asarray(boxes), jnp.asarray(scores), 0.7,
                                   valid=jnp.asarray(valid), class_chunk=8,
                                   legacy=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the extractor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(60, 80), (210, 300), (100, 140)])
def test_preprocess_matches_jax(hw):
    """Flip, mean, then resize (the X101 order); (210, 300) is shrunk
    with antialiasing. Pixels within 2e-3 on the 0-255 scale."""
    cfg = dict(pad_h=128, pad_w=128, short=96, max_size=128)
    img = image(sum(hw), *hw)
    jex = JX.ExtractorX101.__new__(JX.ExtractorX101)   # preprocess needs no weights
    jex.cfg, jex._pre_cache, jex._pre_lock = JX.X101Config(**cfg), {}, threading.Lock()
    want, wnhw, wraw = jex.preprocess(img)
    got, nhw, raw = X.preprocess_x101(img, X.X101Config(**cfg), "cpu")
    assert (nhw, raw) == (wnhw, wraw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-3)


@pytest.fixture(scope="module")
def jax_x101(weights):
    return JX.ExtractorX101(weights[0], JX.X101Config(**FP32))


@pytest.mark.parametrize("seed,hw", [(3, (90, 110)), (4, (128, 70))])
def test_extractor_x101_matches_jax(weights, jax_x101, seed, hw):
    img = image(seed, *hw)
    want = jax_x101.extract(img, "x0")
    ex = X.ExtractorX101(weights[1], X.X101Config(**FP32), device="cpu")
    got = ex.extract(img, "x0")
    assert got.features.shape == (10, 2048) and np.isfinite(got.features).all()
    assert (got.img_w, got.img_h) == (float(hw[1]), float(hw[0]))
    np.testing.assert_array_equal(np.asarray(got.obj_id), np.asarray(want.obj_id))
    for f in ("features", "boxes", "obj_conf"):
        close(getattr(got, f), getattr(want, f), rtol=1e-3, atol=1e-3)
    assert (np.asarray(want.obj_conf) > 0).all()


def test_extractor_x101_outputs_equal_jax_pipeline(weights, jax_x101):
    """The pipeline's raw outputs on one preprocessed image: box order (the
    proposals chosen, in order), ids and the count of boxes kept."""
    img, (nh, nw), _ = jax_x101.preprocess(image(5, 100, 120))
    want = jax_x101._jitted(weights[0], img, jnp.asarray((nh, nw), jnp.int32))
    ex = X.ExtractorX101(weights[1], X.X101Config(**FP32), device="cpu")
    got = ex._pipeline(t(np.asarray(img))[None], torch.tensor([[nh, nw]]))
    np.testing.assert_array_equal(got["obj_id"][0].numpy(), np.asarray(want["obj_id"]))
    assert int(got["num_valid"][0]) == int(want["num_valid"])
    close(got["boxes"][0], want["boxes"], rtol=1e-3, atol=1e-3)
    close(got["features"][0], want["features"], rtol=1e-3, atol=1e-3)


def test_extract_many_device_batch_2_equals_device_batch_1(weights):
    ex = X.ExtractorX101(weights[1], X.X101Config(**FP32), device="cpu")
    items = [(image(20 + k, 90, 110 - 10 * k), f"i{k}") for k in range(3)]
    singles = list(ex.extract_many(iter(items), device_batch=1))
    batched = list(ex.extract_many(iter(items), device_batch=2))
    assert [b.image_id for b in batched] == [s.image_id for s in singles] == ["i0", "i1", "i2"]
    for s, b in zip(singles, batched):
        np.testing.assert_array_equal(b.obj_id, s.obj_id)
        np.testing.assert_allclose(b.boxes, s.boxes, rtol=1e-5, atol=1e-4)
        scale = float(np.abs(s.features).max())
        np.testing.assert_allclose(b.features, s.features, rtol=1e-4, atol=1e-6 * scale)


def test_extractor_x101_bf16_runs(weights):
    ex = X.ExtractorX101(weights[1], X.X101Config(**NARROW), device="cpu")
    assert ex._run_params["backbone"]["res3"][0]["conv2"]["w"].dtype == torch.bfloat16
    assert ex._run_params["rpn"]["conv"]["w"].dtype == torch.float32
    rec = ex.extract(image(6, 90, 110), "b0")
    assert rec.features.shape == (10, 2048) and np.isfinite(rec.features).all()
    assert (rec.boxes >= 0).all() and (rec.boxes[:, 2] <= 110).all()


def test_init_x101_params_has_jaxs_tree(weights):
    tp = X.init_x101_params(torch.Generator().manual_seed(1), X.X101Config(**NARROW))
    assert {k: tuple(v.shape) for k, v in leaves(tp)} == shapes(weights[0])


def test_extractor_x101_runs_on_cuda_unless_asked_for_the_cpu(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        X.ExtractorX101(weights[1], X.X101Config(**FP32))


# ---------------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------------

def x101_state_dict(jp) -> dict:
    """JAX's numpy tree -> vqa-maskrcnn-benchmark names, BN as weight /
    bias with running mean 0 and var 1 - eps (so folding is the identity),
    the anchor buffers of the real .pth, a DataParallel prefix."""
    sd = {}

    def conv(name, p):
        sd[f"{name}.weight"] = np.asarray(p["w"]).transpose(3, 2, 0, 1)
        if "b" in p:
            sd[f"{name}.bias"] = np.asarray(p["b"])

    def bn(name, p):
        sd[f"{name}.weight"] = np.asarray(p["scale"])
        sd[f"{name}.bias"] = np.asarray(p["bias"])
        sd[f"{name}.running_mean"] = np.zeros_like(p["scale"])
        sd[f"{name}.running_var"] = np.full_like(p["scale"], 1.0 - CD.BN_EPS)

    def lin(name, p):
        sd[f"{name}.weight"] = np.asarray(p["w"]).T
        sd[f"{name}.bias"] = np.asarray(p["b"])

    bb = jp["backbone"]
    conv("backbone.body.stem.conv1", bb["stem"]["conv1"])
    bn("backbone.body.stem.bn1", bb["stem"]["bn1"])
    for s in (2, 3, 4, 5):
        for i, blk in enumerate(bb[f"res{s}"]):
            base = f"backbone.body.layer{s - 1}.{i}"
            for j in (1, 2, 3):
                conv(f"{base}.conv{j}", blk[f"conv{j}"])
                bn(f"{base}.bn{j}", blk[f"bn{j}"])
            if "shortcut" in blk:
                conv(f"{base}.downsample.0", blk["shortcut"])
                bn(f"{base}.downsample.1", blk["bn_sc"])
    for i in (1, 2, 3, 4):
        conv(f"backbone.fpn.fpn_inner{i}", jp["fpn"]["lateral"][i - 1])
        conv(f"backbone.fpn.fpn_layer{i}", jp["fpn"]["output"][i - 1])
    conv("rpn.head.conv", jp["rpn"]["conv"])
    conv("rpn.head.cls_logits", jp["rpn"]["objectness"])
    conv("rpn.head.bbox_pred", jp["rpn"]["deltas"])
    lin("roi_heads.box.feature_extractor.fc6", jp["box_head"]["fc6"])
    lin("roi_heads.box.feature_extractor.fc7", jp["box_head"]["fc7"])
    lin("roi_heads.box.predictor.cls_score", jp["predictor"]["cls_score"])
    lin("roi_heads.box.predictor.bbox_pred", jp["predictor"]["bbox_pred"])
    for i in range(5):
        sd[f"rpn.anchor_generator.cell_anchors.{i}"] = np.zeros((3, 4), np.float32)
    return {"module." + k: v for k, v in sd.items()}


def test_x101_converter_gives_jaxs_tree(weights):
    jp, tp = weights
    sd = x101_state_dict(jp)
    assert len(sd) > 550
    got, want = dict(leaves(CD.maskrcnn_x101_to_pytree(sd))), dict(
        leaves(JC.maskrcnn_x101_to_pytree(sd)))
    assert got.keys() == want.keys() == dict(leaves(jp)).keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got[k], dict(leaves(jp))[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    loaded = CD.load_c4_params(CD.maskrcnn_x101_to_pytree(sd))
    assert loaded["backbone"]["res2"][0]["conv2"]["w"].shape == (16, 4, 3, 3)
    for (k, a), (_, b) in zip(leaves(loaded), leaves(tp)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=k)


def test_x101_converter_raises_jaxs_key_error(weights):
    sd = x101_state_dict(weights[0])
    sd["roi_heads.mask.feature_extractor.mask_fcn1.weight"] = np.zeros((1,), np.float32)
    sd["module.roi_heads.box.predictor.extra.bias"] = np.zeros((1,), np.float32)
    with pytest.raises(KeyError) as want:
        JC.maskrcnn_x101_to_pytree(sd)
    with pytest.raises(KeyError) as got:
        CD.maskrcnn_x101_to_pytree(sd)
    assert str(got.value) == str(want.value)
    assert "unmapped checkpoint keys" in str(got.value)
