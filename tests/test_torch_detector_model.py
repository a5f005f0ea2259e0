"""The port's R101-C4 detector (``models/detector``) against the JAX package,
from weights carried across from JAX's ``init_extractor_params`` (as numpy,
through ``utils/convert_detector.load_c4_params``) on the same numpy inputs.

Tolerances, fp32: layers within rtol 1e-4 and an atol of 1e-5 of the
largest |value| (random-init R101 activations reach ~1e8, so a fixed atol
would test nothing there; the two frameworks sum convs in other orders).
Indices, keep masks, class and attribute ids and the NMS threshold must be
equal. The whole extractor: features and boxes within rtol 1e-3 of the
largest value.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clg_vqa_tpu.models.detector import extractor as JE
from clg_vqa_tpu.models.detector import heads as JH
from clg_vqa_tpu.models.detector import resnet as JR
from clg_vqa_tpu.models.detector import rpn as JP
from clg_vqa_tpu_torch.models.detector import extractor as E
from clg_vqa_tpu_torch.models.detector import heads as H
from clg_vqa_tpu_torch.models.detector import resnet as R
from clg_vqa_tpu_torch.models.detector import rpn as P
from clg_vqa_tpu_torch.utils.convert_detector import load_c4_params

torch.set_num_threads(1)

TINY = dict(num_boxes=6, pre_nms_topk=200, post_nms_topk=24, pad_h=128,
            pad_w=160, short=96, max_size=160, bf16=False)


def close(got, want, rtol=1e-4, atol=1e-5):
    want = np.asarray(want, np.float64)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def weights():
    """(JAX tree as numpy, the port's tree) of JAX's random R101-C4."""
    jp = jax.tree.map(np.asarray, JE.init_extractor_params(jax.random.key(0)))
    return jp, load_c4_params(jp)


def nhwc(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("stride,in1x1,dilation", [(1, True, 1), (2, True, 1),
                                                   (2, False, 1), (1, True, 2)])
def test_bottleneck_matches_jax(stride, in1x1, dilation):
    r = np.random.RandomState(0)
    p = JR._init_bottleneck(jax.random.key(0), 32, 16, 64, shortcut=True)
    p = jax.tree.map(lambda x: r.randn(*x.shape).astype(np.float32), p)
    x = r.randn(2, 9, 11, 32).astype(np.float32)
    want = JR.bottleneck(jnp.asarray(x), p, stride=stride, dilation=dilation,
                         stride_in_1x1=in1x1)
    got = R.bottleneck(nhwc(x), load_c4_params(p), stride=stride,
                       dilation=dilation, stride_in_1x1=in1x1)
    close(got, want)


def test_caffe_maxpool_matches_jax():
    for h, w in [(10, 10), (11, 13), (7, 8)]:
        x = np.random.RandomState(1).randn(1, h, w, 4).astype(np.float32)
        np.testing.assert_array_equal(R.caffe_maxpool(nhwc(x)).numpy(),
                                      np.asarray(JR.caffe_maxpool(jnp.asarray(x))))


def test_stem_and_backbone_c4_match_jax(weights):
    jp, tp = weights
    x = np.random.RandomState(2).randn(1, 64, 96, 3).astype(np.float32) * 50
    close(R.stem(nhwc(x), tp["backbone"]["stem"]),
          JR.stem(jnp.asarray(x), jp["backbone"]["stem"]))
    got = R.backbone_c4(nhwc(x), tp["backbone"])
    assert got.shape == (1, 4, 6, 1024)                   # stride 16
    close(got, JR.backbone_c4(jnp.asarray(x), jp["backbone"]))


def test_res5_head_matches_jax(weights):
    jp, tp = weights
    crops = np.abs(np.random.RandomState(3).randn(2, 7, 7, 1024)).astype(np.float32)
    pooled, x = R.res5_head(nhwc(crops), tp["res5"], halve=False)
    jpooled, jx = JR.res5_head(jnp.asarray(crops), jp["res5"], halve=False)
    assert x.shape == (2, 7, 7, 2048)                     # stride 1, dilation 2
    close(x, jx)
    close(pooled, jpooled)


def test_anchors_decode_and_clip_match_jax():
    np.testing.assert_array_equal(P.generate_anchors(5, 7, stride=16),
                                  JP.generate_anchors(5, 7, stride=16))
    r = np.random.RandomState(4)
    a = P.generate_anchors(3, 4)
    d = (r.randn(len(a), 4) * [1, 1, 3, 3]).astype(np.float32)   # some clamped
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        got = P.decode_boxes(torch.from_numpy(a), torch.from_numpy(d), weights=w)
        close(got, JP.decode_boxes(jnp.asarray(a), jnp.asarray(d), weights=w),
              rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        P.clip_boxes(torch.from_numpy(a), 30, 50).numpy(),
        np.asarray(JP.clip_boxes(jnp.asarray(a), 30, 50)))


def test_rpn_head_and_propose_match_jax(weights):
    jp, tp = weights
    r = np.random.RandomState(5)
    feat = np.abs(r.randn(1, 8, 10, 1024)).astype(np.float32)
    obj, deltas = P.rpn_head(nhwc(feat), tp["rpn"])
    jobj, jdeltas = JP.rpn_head(jnp.asarray(feat), jp["rpn"])
    close(obj, jobj)
    close(deltas, jdeltas)
    # propose on the same objectness and deltas (ties included), with a mask
    o = np.round(np.asarray(jobj[0]) * 4) / 4
    dl = np.asarray(jdeltas[0])
    anchors = P.generate_anchors(8, 10)
    vmask = np.broadcast_to((np.arange(8)[:, None, None] < 6)
                            & (np.arange(10)[None, :, None] < 9), o.shape).reshape(-1)
    got = P.propose(torch.from_numpy(o), torch.from_numpy(dl),
                    torch.from_numpy(anchors), (90, 140), pre_nms_topk=200,
                    post_nms_topk=50, valid_mask=torch.from_numpy(vmask.copy()))
    want = JP.propose(jnp.asarray(o), jnp.asarray(dl), jnp.asarray(anchors),
                      jnp.asarray([90, 140]), pre_nms_topk=200, post_nms_topk=50,
                      valid_mask=jnp.asarray(vmask))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    close(got[0], want[0], rtol=1e-6, atol=1e-7)


def test_box_predictor_and_predict_boxes_match_jax(weights):
    jp, tp = weights
    feats = np.abs(np.random.RandomState(6).randn(20, 2048)).astype(np.float32)
    got = H.box_predictor(torch.from_numpy(feats), tp["predictor"])
    want = JH.box_predictor(jnp.asarray(feats), jp["predictor"])
    for g, w in zip(got, want):
        close(g, w)
    props = JP.generate_anchors(2, 10)[:20] + 100.0
    close(H.predict_boxes(torch.from_numpy(props), got[2]),
          JH.predict_boxes(jnp.asarray(props), want[2]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["random", "valid", "fall_through"])
def test_select_exactly_n_matches_jax(case):
    r = np.random.RandomState(7)
    Rn, C = 40, 6
    ctr = r.rand(Rn, 2) * 60 + 20
    size = r.rand(Rn, C, 2) * 40 + 10
    boxes = np.concatenate([ctr[:, None] - size / 2, ctr[:, None] + size / 2],
                           -1).astype(np.float32)
    logits = r.randn(Rn, C + 1)
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    valid = None if case == "random" else r.rand(Rn) > 0.2
    n_keep = 48 if case == "fall_through" else 8     # 48 > 40: never exact
    got = H.select_exactly_n(torch.from_numpy(boxes), torch.from_numpy(probs),
                             (90, 100), n_keep=n_keep,
                             valid=None if valid is None else torch.from_numpy(valid))
    want = JH.select_exactly_n(jnp.asarray(boxes), jnp.asarray(probs),
                               jnp.asarray([90, 100]), n_keep=n_keep,
                               valid=None if valid is None else jnp.asarray(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "fall_through":
        assert float(got[2]) == pytest.approx(0.9)


def scaled(jp, s: float):
    """The tree with every frozen-BN scale multiplied by s: random-init R101
    saturates the softmax (every box one class); a damped copy gives spread
    scores, so the selection has real choices to make."""
    def f(path, x):
        return x * s if path[-1].key == "scale" else x
    return jax.tree_util.tree_map_with_path(f, jp)


def jax_image(seed, h, w):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


@pytest.mark.parametrize("bn_scale", [1.0, 0.35])
def test_extractor36_matches_jax(weights, bn_scale):
    jp, _ = weights
    jp = scaled(jp, bn_scale)
    img = jax_image(0, 100, 140)
    want = JE.Extractor36(jp, JE.ExtractorConfig(**TINY)).extract(img, "img0")
    got = E.Extractor36(load_c4_params(jp), E.ExtractorConfig(**TINY),
                        device="cpu").extract(img, "img0")
    for k in ("obj_id", "attr_id"):
        np.testing.assert_array_equal(np.asarray(got.__dict__[k]),
                                      np.asarray(want.__dict__[k]), err_msg=k)
    close(got.features, want.features, rtol=1e-3, atol=1e-3)
    close(got.boxes, want.boxes, rtol=1e-3, atol=1e-3)
    close(got.obj_conf, want.obj_conf, rtol=1e-3, atol=1e-3)
    assert (got.img_w, got.img_h) == (140.0, 100.0)
    assert got.features.shape == (6, 2048) and np.isfinite(got.features).all()


def test_extractor36_selection_equals_jax(weights):
    """The pipeline's raw outputs on one preprocessed image: the 6 slot
    indices' features, the keep mask and the NMS threshold used."""
    jp, _ = weights
    jp = scaled(jp, 0.35)
    jex = JE.Extractor36(jp, JE.ExtractorConfig(**TINY))
    img, (nh, nw), _ = jex.preprocess(jax_image(1, 90, 120))
    want = jex._jitted(jp, img, jnp.asarray((nh, nw), jnp.int32))
    tex = E.Extractor36(load_c4_params(jp), E.ExtractorConfig(**TINY), device="cpu")
    got = tex._pipeline(nhwc(np.asarray(img))[None], torch.tensor([[nh, nw]]))
    for k in ("obj_id", "attr_id", "keep", "nms_thresh"):
        np.testing.assert_array_equal(got[k][0].numpy(), np.asarray(want[k]), err_msg=k)
    close(got["features"][0], want["features"], rtol=1e-3, atol=1e-3)


def test_extract_many_device_batch_2_matches_device_batch_1(weights):
    """Batched convs sum in another order than single ones, which can flip a
    near-tied pick under random weights: as JAX's own test demands, most
    boxes agree exactly and the agreeing rows' features and ids match."""
    _, tp = weights
    cfg = dict(TINY, pad_h=64, pad_w=96, short=48, max_size=96, post_nms_topk=12,
               num_boxes=4)
    ex = E.Extractor36(tp, E.ExtractorConfig(**cfg), device="cpu")
    items = [(jax_image(11 + k, 50, 70), f"c{k}") for k in range(3)]
    singles = list(ex.extract_many(iter(items), device_batch=1))
    batched = list(ex.extract_many(iter(items), device_batch=2))
    assert [b.image_id for b in batched] == [s.image_id for s in singles] == ["c0", "c1", "c2"]
    for s, b in zip(singles, batched):
        agree = np.all(np.isclose(b.boxes, s.boxes, rtol=1e-5, atol=1e-4), axis=1)
        assert agree.mean() >= 0.8, agree
        scale = float(np.abs(s.features).max()) or 1.0
        np.testing.assert_allclose(b.features[agree], s.features[agree],
                                   rtol=2e-3, atol=1e-5 * scale)
        np.testing.assert_array_equal(b.obj_id[agree], s.obj_id[agree])


def test_given_box_extractor_matches_jax(weights):
    jp, tp = weights
    cfg = dict(pad_h=128, pad_w=160, short=96, max_size=160)
    img = jax_image(1, 100, 140)
    boxes = np.asarray([[5, 5, 60, 60], [30, 20, 120, 90]], np.float32)
    want = JE.GivenBoxExtractor(jp, JE.ExtractorConfig(**cfg), max_boxes=4).extract(
        img, boxes, "gb0")
    got = E.GivenBoxExtractor(tp, E.ExtractorConfig(**cfg), max_boxes=4,
                              device="cpu").extract(img, boxes, "gb0")
    np.testing.assert_array_equal(got.boxes, boxes)
    np.testing.assert_array_equal(got.obj_id, np.asarray(want.obj_id))
    np.testing.assert_array_equal(got.attr_id, np.asarray(want.attr_id))
    close(got.features, want.features, rtol=1e-3, atol=1e-3)


def test_extractor_runs_on_cuda_unless_asked_for_the_cpu(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.Extractor36(weights[1], E.ExtractorConfig(**TINY))
