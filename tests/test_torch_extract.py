"""The port's extraction front and back end against the JAX package:
preprocessing (resize, mean, pad), the C4 checkpoint converter and its
loader into the port, and ``cli extract --device cpu`` against the JAX
CLI on the same images and weights, for ``--detector c4`` and ``x101``.

Tolerances: preprocessed pixels within 2e-3 (0-255 scale; both resize with
a triangle filter on pixel centres, antialiased when shrinking, and sum in
other orders); converter trees exact (rtol 1e-6 after BN folding); the CLI
stores, both CLIs in fp32: the same image ids, sizes, object and attribute
ids, and features, boxes and confidences within rtol 1e-3 and 1e-3 of the
largest value (convs summed in other orders). The port's CLI also runs its
default bf16 config (``--limit``, ``--device_batch``). The X101 stores: the
same at a narrow X101Config (the widths of ``test_torch_x101.py``), the
object ids and the box order equal.
"""
import functools
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clg_vqa_tpu.cli.__main__ import main as jax_cli
from clg_vqa_tpu.data.cfs import CfsReader as JaxCfsReader
from clg_vqa_tpu.models.detector import extractor as JE
from clg_vqa_tpu.models.detector import extractor_x101 as JX
from clg_vqa_tpu.utils import convert_detector as JC
from clg_vqa_tpu_torch.cli.__main__ import main as cli
from clg_vqa_tpu_torch.data.cfs import CfsReader
from clg_vqa_tpu_torch.models.detector import extractor as E
from clg_vqa_tpu_torch.models.detector import extractor_x101 as X
from clg_vqa_tpu_torch.utils import convert_detector as CD
from test_torch_x101 import NARROW, damped, x101_state_dict

torch.set_num_threads(1)

TINY = ["--short", "96", "--max_size", "160", "--pad_h", "128", "--pad_w", "160",
        "--num_boxes", "6", "--pre_nms_topk", "200", "--post_nms_topk", "24"]


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, JE.init_extractor_params(jax.random.key(0)))


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def assert_trees_equal(a, b, rtol=0.0):
    fa, fb = dict(_walk(a)), dict(_walk(b))
    assert fa.keys() == fb.keys(), sorted(set(fa) ^ set(fb))[:10]
    for k in fa:
        np.testing.assert_allclose(fa[k], fb[k], rtol=rtol, atol=rtol, err_msg=k)


@pytest.mark.parametrize("hw", [(60, 80), (210, 300), (100, 140)])
def test_preprocess_matches_jax(hw):
    """(60, 80) is enlarged to 96 x 128, (210, 300) shrunk to 96 x 137 (the
    antialiased case), (100, 140) shrunk slightly."""
    import threading
    cfg = dict(pad_h=128, pad_w=160, short=96, max_size=160)
    img = (np.random.RandomState(sum(hw)).rand(*hw, 3) * 255).astype(np.uint8)
    jex = JE.Extractor36.__new__(JE.Extractor36)      # preprocess needs no weights
    jex.cfg, jex._pre_cache, jex._pre_lock = (JE.ExtractorConfig(**cfg), {},
                                              threading.Lock())
    want, wnhw, wraw = jex.preprocess(img)
    got, nhw, raw = E.preprocess(img, E.ExtractorConfig(**cfg), "cpu")
    assert (nhw, raw) == (wnhw, wraw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-3)


def _d2_to_caffe_name(k: str) -> str:
    """Independent inverse of the caffe2 -> detectron2 renaming."""
    m = re.match(r"^backbone\.stem\.conv1\.(weight|bias)$", k)
    if m:
        return "conv1_" + ("w" if m.group(1) == "weight" else "b")
    m = re.match(r"^backbone\.stem\.conv1\.norm\.(weight|bias)$", k)
    if m:
        return "res_conv1_bn_" + ("s" if m.group(1) == "weight" else "b")
    m = re.match(r"^(?:backbone\.res(\d)|roi_heads\.(res5))\.(\d+)\.(conv[123]|"
                 r"shortcut)(\.norm)?\.(weight|bias)$", k)
    if m:
        stage = m.group(1) or "5"
        blk, mod, norm, wb = m.group(3), m.group(4), m.group(5), m.group(6)
        br = {"conv1": "branch2a", "conv2": "branch2b", "conv3": "branch2c",
              "shortcut": "branch1"}[mod]
        tail = ("s" if wb == "weight" else "b") if norm else ("w" if wb == "weight" else "b")
        return f"res{stage}_{blk}_{br}_{'bn_' if norm else ''}{tail}"
    flat = dict((d2, c2) for c2, d2 in CD._C2_FLAT)
    m = re.match(r"^(.*)\.(weight|bias)$", k)
    assert m and m.group(1) in flat, k
    return flat[m.group(1)] + "_" + ("w" if m.group(2) == "weight" else "b")


def test_c4_caffe_pkl_inventory_round_trips(jax_params):
    d2 = CD.pytree_to_detectron2_c4(jax_params)
    assert d2.keys() == JC.pytree_to_detectron2_c4(jax_params).keys()
    caffe = {_d2_to_caffe_name(k): v for k, v in d2.items()}
    assert len(caffe) == len(d2) > 300
    got = CD.detectron2_c4_to_pytree(caffe)
    assert_trees_equal(got, jax_params)
    assert_trees_equal(got, JC.detectron2_c4_to_pytree(caffe))


def test_c4_detectron2_names_with_model_prefix_round_trip(jax_params):
    sd = {"model." + k: v for k, v in CD.pytree_to_detectron2_c4(jax_params).items()}
    assert_trees_equal(CD.detectron2_c4_to_pytree(sd), jax_params)


def test_c4_unmapped_key_raises_and_bn_folds(jax_params):
    sd = CD.pytree_to_detectron2_c4(jax_params)
    sd["roi_heads.mask_head.deconv.weight"] = np.zeros((1,), np.float32)
    with pytest.raises(KeyError, match="unmapped"):
        CD.detectron2_c4_to_pytree(sd)
    sd.pop("roi_heads.mask_head.deconv.weight")
    sd["pixel_mean"] = np.zeros((3,), np.float32)        # ignored, no raise
    s = sd.pop("backbone.stem.conv1.norm.weight")
    b = sd.pop("backbone.stem.conv1.norm.bias")
    var = np.random.RandomState(0).rand(len(s)).astype(np.float32)
    mean = np.random.RandomState(1).randn(len(s)).astype(np.float32)
    sd["backbone.stem.conv1.norm.weight"] = s * np.sqrt(var + CD.BN_EPS)
    sd["backbone.stem.conv1.norm.bias"] = b + mean * s
    sd["backbone.stem.conv1.norm.running_mean"] = mean
    sd["backbone.stem.conv1.norm.running_var"] = var
    got = CD.detectron2_c4_to_pytree(sd)
    assert_trees_equal(got, JC.detectron2_c4_to_pytree(sd))
    np.testing.assert_allclose(got["backbone"]["stem"]["bn1"]["scale"], s, rtol=1e-5)


def test_load_c4_params_round_trips(jax_params):
    tp = CD.load_c4_params(jax_params)
    w = tp["backbone"]["res4"][22]["conv2"]["w"]
    assert w.shape == (256, 256, 3, 3)                   # OIHW; res4 has 23 blocks
    np.testing.assert_array_equal(
        w.numpy(), jax_params["backbone"]["res4"][22]["conv2"]["w"].transpose(3, 2, 0, 1))
    assert tp["predictor"]["cls_score"]["w"].shape == (2048, 1601)
    assert_trees_equal(CD.c4_params_to_pytree(tp), jax_params)


@pytest.fixture(scope="module")
def images(tmp_path_factory, jax_params):
    """Three .npy images of different sizes, an undecodable file, and the
    JAX random weights as a detectron2-named torch state dict both CLIs
    load."""
    d = tmp_path_factory.mktemp("extract")
    imgs = d / "images"
    imgs.mkdir()
    r = np.random.RandomState(0)
    for i, (h, w) in enumerate([(80, 100), (90, 124), (100, 112)]):
        np.save(imgs / f"i{i}.npy", (r.rand(h, w, 3) * 255).astype(np.uint8))
    (imgs / "notes.txt").write_text("not an image")
    weights = d / "c4.pth"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in JC.pytree_to_detectron2_c4(jax_params).items()}, weights)
    return d, imgs, weights


def assert_stores_agree(got, want, n_boxes: int, attrs: bool = False) -> None:
    """The records of both stores: the same ids, sizes and object (and
    attribute) ids, values within rtol 1e-3 and 1e-3 of the largest."""
    assert sorted(got.keys()) == sorted(want.keys()) == ["i0", "i1", "i2"]
    for key in want.keys():
        a, b = want.get(key), got.get(key)
        assert (b.img_w, b.img_h) == (a.img_w, a.img_h)
        assert b.features.shape == (n_boxes, 2048) and np.isfinite(b.features).all()
        np.testing.assert_array_equal(b.obj_id, a.obj_id)
        if attrs:
            np.testing.assert_array_equal(b.attr_id, a.attr_id)
        for f in ("features", "boxes", "obj_conf") + (("attr_conf",) if attrs else ()):
            x, y = getattr(b, f), getattr(a, f)
            np.testing.assert_allclose(x, y, rtol=1e-3,
                                       atol=1e-3 * max(np.abs(y).max(), 1e-6),
                                       err_msg=f)
        assert (b.boxes[:, 2] <= b.img_w).all() and (b.boxes[:, 3] <= b.img_h).all()


def test_cli_extract_writes_the_jax_clis_records(images, monkeypatch):
    """Both CLIs in fp32 (their config class patched to bf16=False: in bf16
    the frameworks round elementwise steps at other places, which can flip a
    near-tied pick)."""
    d, imgs, weights = images
    monkeypatch.setattr(JE, "ExtractorConfig",
                        functools.partial(JE.ExtractorConfig, bf16=False))
    monkeypatch.setattr(E, "ExtractorConfig",
                        functools.partial(E.ExtractorConfig, bf16=False))
    args = ["extract", "--images", str(imgs), "--detector", "c4", "--weights",
            str(weights), *TINY]
    jax_cli(args + ["--out", str(d / "jax.cfs")])
    cli(args + ["--out", str(d / "port.cfs"), "--device", "cpu"])
    assert_stores_agree(CfsReader(str(d / "port.cfs")), JaxCfsReader(str(d / "jax.cfs")),
                        6, attrs=True)


def test_cli_extract_limit_device_batch_and_x101(images, monkeypatch):
    """``--limit`` and ``--device_batch`` on the C4 path; then
    ``--detector x101`` writes the JAX CLI's records for the same images:
    JAX's narrow X101 weights as a vqa-maskrcnn-benchmark ``.pth``, both
    CLIs in fp32 at the narrow widths (their X101Config patched), the size
    overrides on the command line, the port at device_batch 2."""
    d, imgs, weights = images
    out = d / "lim.cfs"
    cli(["extract", "--images", str(imgs), "--out", str(out), "--limit", "2",
         "--device_batch", "2", "--device", "cpu", "--weights", str(weights),
         *TINY])
    assert sorted(CfsReader(str(out)).keys()) == ["i0", "i1"]

    widths = {k: NARROW[k] for k in ("groups", "width_per_group", "fpn_channels")}
    monkeypatch.setattr(JX, "X101Config",
                        functools.partial(JX.X101Config, bf16=False, **widths))
    monkeypatch.setattr(X, "X101Config",
                        functools.partial(X.X101Config, bf16=False, **widths))
    jp = jax.tree.map(np.asarray, damped(JX.init_x101_params(
        jax.random.key(0), JX.X101Config())))
    pth = d / "x101.pth"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in x101_state_dict(jp).items()}, pth)
    args = ["extract", "--images", str(imgs), "--detector", "x101", "--weights",
            str(pth), "--short", "96", "--max_size", "128", "--pad_h", "128",
            "--pad_w", "128", "--num_boxes", "10", "--pre_nms_topk", "64",
            "--post_nms_topk", "64"]
    jax_cli(args + ["--out", str(d / "jax_x101.cfs")])
    cli(args + ["--out", str(d / "port_x101.cfs"), "--device", "cpu",
                "--device_batch", "2"])
    assert_stores_agree(CfsReader(str(d / "port_x101.cfs")),
                        JaxCfsReader(str(d / "jax_x101.cfs")), 10)


def test_cli_extract_x101_refuses_a_caffe_pkl_as_jax_does(images, tmp_path):
    _, imgs, _ = images
    pkl = tmp_path / "w.pkl"
    pkl.write_bytes(b"not read")
    args = ["extract", "--images", str(imgs), "--out", str(tmp_path / "o.cfs"),
            "--detector", "x101", "--weights", str(pkl)]
    with pytest.raises(ValueError) as want:
        jax_cli(args)
    with pytest.raises(ValueError) as got:
        cli(args + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert not (tmp_path / "o.cfs").exists()
