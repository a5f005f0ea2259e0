"""Detector checkpoint ingest for the R101-C4 and X101-FPN extractors (own
copy of clg_vqa_tpu/utils/convert_detector.py), plus the loader of either
numpy pytree into the port.

The reference's 36-box extractor loads ``faster_rcnn_from_caffe_attr.pkl``
through detectron2's caffe2 loader, which renames caffe2 keys
(res2_0_branch2a_w ...) to detectron2 names (backbone.res2.0.conv1.weight
...). ``detectron2_c4_to_pytree`` takes the detectron2 names (or the raw
caffe2 ones) and returns the JAX package's pytree: numpy, conv weights
HWIO, linear weights [in, out], BatchNorm folded (scale = gamma /
sqrt(var + eps), bias = beta - mean * scale). ``maskrcnn_x101_to_pytree``
does the same for vqa-maskrcnn-benchmark's X101 ``detectron_model.pth``.
``load_c4_params`` turns either pytree (or the JAX package's random trees
as numpy) into the port's tree: torch tensors, conv weights OIHW (grouped
ones [cout, cin/groups, k, k]); ``c4_params_to_pytree`` inverts it.
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from ..models.detector.resnet import STAGE_BLOCKS

BN_EPS = 1e-5   # FrozenBatchNorm2d default


def _fold_bn(sd, prefix):
    if f"{prefix}.weight" in sd and f"{prefix}.running_var" not in sd:
        # an already-folded affine (caffe pkls converted by detectron2)
        return {"scale": np.asarray(sd[f"{prefix}.weight"], np.float32),
                "bias": np.asarray(sd[f"{prefix}.bias"], np.float32)}
    gamma = np.asarray(sd[f"{prefix}.weight"], np.float32)
    beta = np.asarray(sd[f"{prefix}.bias"], np.float32)
    mean = np.asarray(sd[f"{prefix}.running_mean"], np.float32)
    var = np.asarray(sd[f"{prefix}.running_var"], np.float32)
    scale = gamma / np.sqrt(var + BN_EPS)
    return {"scale": scale, "bias": beta - mean * scale}


def _conv(sd, name):
    p = {"w": np.asarray(sd[f"{name}.weight"], np.float32).transpose(2, 3, 1, 0)}
    if f"{name}.bias" in sd:
        p["b"] = np.asarray(sd[f"{name}.bias"], np.float32)
    return p


def _lin(sd, name):
    return {"w": np.asarray(sd[f"{name}.weight"], np.float32).T,
            "b": np.asarray(sd[f"{name}.bias"], np.float32)}


_C2_FLAT = (("conv_rpn", "proposal_generator.rpn_head.conv"),
            ("rpn_cls_logits", "proposal_generator.rpn_head.objectness_logits"),
            ("rpn_bbox_pred", "proposal_generator.rpn_head.anchor_deltas"),
            ("cls_score", "roi_heads.box_predictor.cls_score"),
            ("bbox_pred", "roi_heads.box_predictor.bbox_pred"),
            ("fc_attr", "roi_heads.box_predictor.fc_attr"),
            ("attr_score", "roi_heads.box_predictor.attr_score"),
            ("cls_embedding", "roi_heads.box_predictor.cls_embedding"))


def caffe2_to_detectron2_names(sd: Mapping[str, np.ndarray]) -> dict:
    """Minimal caffe2 -> detectron2 renamer for R-C4 models (the subset of
    c2_model_loading.py the VG checkpoint needs)."""
    out = {}
    branch2 = {"branch2a": "conv1", "branch2b": "conv2", "branch2c": "conv3"}
    for k, v in sd.items():
        nk = None
        m = re.match(r"^conv1_(w|b)$", k)
        if m:
            nk = f"backbone.stem.conv1.{'weight' if m.group(1) == 'w' else 'bias'}"
        m = re.match(r"^res_conv1_bn_(s|b)$", k)
        if m:
            nk = f"backbone.stem.conv1.norm.{'weight' if m.group(1) == 's' else 'bias'}"
        m = re.match(r"^res(\d)_(\d+)_branch(2[abc]|1)_(w|b)$", k)
        if m:
            stage, blk, br, sb = m.groups()
            mod = branch2.get(f"branch{br}", "shortcut")
            base = (f"backbone.res{stage}.{blk}" if int(stage) < 5
                    else f"roi_heads.res5.{blk}")
            nk = f"{base}.{mod}.{'weight' if sb == 'w' else 'bias'}"
        m = re.match(r"^res(\d)_(\d+)_branch(2[abc]|1)_bn_(s|b)$", k)
        if m:
            stage, blk, br, sb = m.groups()
            mod = branch2.get(f"branch{br}", "shortcut")
            base = (f"backbone.res{stage}.{blk}" if int(stage) < 5
                    else f"roi_heads.res5.{blk}")
            nk = f"{base}.{mod}.norm.{'weight' if sb == 's' else 'bias'}"
        for c2, d2 in _C2_FLAT:
            m = re.match(rf"^{c2}_(w|b)$", k)
            if m:
                nk = f"{d2}.{'weight' if m.group(1) == 'w' else 'bias'}"
        out[nk or k] = v
    return out


def _blocks(sd, base, n):
    blocks = []
    for i in range(n):
        p = {"conv1": _conv(sd, f"{base}.{i}.conv1"),
             "bn1": _fold_bn(sd, f"{base}.{i}.conv1.norm"),
             "conv2": _conv(sd, f"{base}.{i}.conv2"),
             "bn2": _fold_bn(sd, f"{base}.{i}.conv2.norm"),
             "conv3": _conv(sd, f"{base}.{i}.conv3"),
             "bn3": _fold_bn(sd, f"{base}.{i}.conv3.norm")}
        if f"{base}.{i}.shortcut.weight" in sd:
            p["shortcut"] = _conv(sd, f"{base}.{i}.shortcut")
            p["bn_sc"] = _fold_bn(sd, f"{base}.{i}.shortcut.norm")
        blocks.append(p)
    return blocks


#: checkpoint entries that carry no weight the pipeline needs (normalization
#: buffers come from the config; anchors are regenerated)
_C4_IGNORED = re.compile(r"pixel_mean|pixel_std|anchor_generator|cell_anchors")


def detectron2_c4_to_pytree(sd: Mapping[str, np.ndarray], *, depth: int = 101,
                            strict: bool = True) -> dict:
    """A detectron2-named (or raw caffe2-named) VG R-C4 checkpoint -> the
    extractor's numpy pytree (JAX layout). strict: raise KeyError listing
    any key neither consumed nor on the no-weight ignore list."""
    if any(k.startswith("res2_0") or k == "conv1_w" for k in sd):
        sd = caffe2_to_detectron2_names(sd)
    sd = {k.replace("model.", "", 1) if k.startswith("model.") else k: v
          for k, v in sd.items()}
    used: set[str] = set()

    class _Track(dict):
        def __getitem__(self, k):
            used.add(k)
            return dict.__getitem__(self, k)

    sd = _Track(sd)
    n2, n3, n4, n5 = STAGE_BLOCKS[depth]
    params = {
        "backbone": {
            "stem": {"conv1": _conv(sd, "backbone.stem.conv1"),
                     "bn1": _fold_bn(sd, "backbone.stem.conv1.norm")},
            "res2": _blocks(sd, "backbone.res2", n2),
            "res3": _blocks(sd, "backbone.res3", n3),
            "res4": _blocks(sd, "backbone.res4", n4),
        },
        "res5": {"res5": _blocks(sd, "roi_heads.res5", n5)},
        "rpn": {
            "conv": _conv(sd, "proposal_generator.rpn_head.conv"),
            "objectness": _conv(sd, "proposal_generator.rpn_head.objectness_logits"),
            "deltas": _conv(sd, "proposal_generator.rpn_head.anchor_deltas"),
        },
        "predictor": {
            "cls_score": _lin(sd, "roi_heads.box_predictor.cls_score"),
            "bbox_pred": _lin(sd, "roi_heads.box_predictor.bbox_pred"),
            "cls_embedding": np.asarray(
                sd["roi_heads.box_predictor.cls_embedding.weight"], np.float32),
            "fc_attr": _lin(sd, "roi_heads.box_predictor.fc_attr"),
            "attr_score": _lin(sd, "roi_heads.box_predictor.attr_score"),
        },
    }
    if strict:
        leftovers = [k for k in sd if k not in used and not _C4_IGNORED.search(k)]
        if leftovers:
            raise KeyError(f"unmapped checkpoint keys: {sorted(leftovers)[:10]}"
                           f" (+{max(len(leftovers) - 10, 0)} more)")
    return params


#: state-dict keys that carry no learnable weights (the RPN's anchors are
#: regenerated from the config; BufferList registers them,
#: anchor_generator.py:49-58)
_X101_IGNORED = re.compile(r"(^|\.)anchor_generator\.|cell_anchors")


def maskrcnn_x101_to_pytree(sd: Mapping[str, np.ndarray]) -> dict:
    """vqa-maskrcnn-benchmark ``detectron_model.pth`` (GeneralizedRCNN,
    X-101-64x4d FPN-512) -> the X101 extractor's numpy pytree (JAX layout).

    Key names: backbone.body.stem.{conv1,bn1}; backbone.body.layer{1..4}.{i}
    .{conv,bn}{1,2,3} and .downsample.{0,1}; backbone.fpn.fpn_inner{1..4} /
    fpn_layer{1..4}; rpn.head.{conv,cls_logits,bbox_pred};
    roi_heads.box.feature_extractor.{fc6,fc7};
    roi_heads.box.predictor.{cls_score,bbox_pred}; a DataParallel
    ``module.`` prefix is dropped. fc6 reads the crop flattened
    channel-first, as torch's .view does. Raises KeyError listing the
    leftovers if a key outside ``_X101_IGNORED`` goes unused."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    used: set[str] = set()

    class _Track(dict):
        def __getitem__(self, k):
            used.add(k)
            return dict.__getitem__(self, k)

    t = _Track(sd)

    def blocks(stage_idx: int, n: int):
        base = f"backbone.body.layer{stage_idx}"
        out = []
        for i in range(n):
            p = {"conv1": _conv(t, f"{base}.{i}.conv1"),
                 "bn1": _fold_bn(t, f"{base}.{i}.bn1"),
                 "conv2": _conv(t, f"{base}.{i}.conv2"),
                 "bn2": _fold_bn(t, f"{base}.{i}.bn2"),
                 "conv3": _conv(t, f"{base}.{i}.conv3"),
                 "bn3": _fold_bn(t, f"{base}.{i}.bn3")}
            if f"{base}.{i}.downsample.0.weight" in sd:
                p["shortcut"] = _conv(t, f"{base}.{i}.downsample.0")
                p["bn_sc"] = _fold_bn(t, f"{base}.{i}.downsample.1")
            out.append(p)
        return out

    n2, n3, n4, n5 = STAGE_BLOCKS[101]
    params = {
        "backbone": {
            "stem": {"conv1": _conv(t, "backbone.body.stem.conv1"),
                     "bn1": _fold_bn(t, "backbone.body.stem.bn1")},
            "res2": blocks(1, n2), "res3": blocks(2, n3),
            "res4": blocks(3, n4), "res5": blocks(4, n5),
        },
        "fpn": {
            "lateral": [_conv(t, f"backbone.fpn.fpn_inner{i}") for i in (1, 2, 3, 4)],
            "output": [_conv(t, f"backbone.fpn.fpn_layer{i}") for i in (1, 2, 3, 4)],
        },
        "rpn": {"conv": _conv(t, "rpn.head.conv"),
                "objectness": _conv(t, "rpn.head.cls_logits"),
                "deltas": _conv(t, "rpn.head.bbox_pred")},
        "box_head": {"fc6": _lin(t, "roi_heads.box.feature_extractor.fc6"),
                     "fc7": _lin(t, "roi_heads.box.feature_extractor.fc7")},
        "predictor": {"cls_score": _lin(t, "roi_heads.box.predictor.cls_score"),
                      "bbox_pred": _lin(t, "roi_heads.box.predictor.bbox_pred")},
    }
    leftovers = [k for k in sd if k not in used and not _X101_IGNORED.search(k)]
    if leftovers:
        raise KeyError(f"unmapped checkpoint keys: {sorted(leftovers)[:10]}"
                       f" (+{max(len(leftovers) - 10, 0)} more)")
    return params


def pytree_to_detectron2_c4(params: dict) -> dict[str, np.ndarray]:
    """Inverse of ``detectron2_c4_to_pytree`` (folded-BN affine form)."""
    sd: dict[str, np.ndarray] = {}

    def put_conv(name, p):
        sd[f"{name}.weight"] = np.asarray(p["w"]).transpose(3, 2, 0, 1)
        if "b" in p:
            sd[f"{name}.bias"] = np.asarray(p["b"])

    def put_bn(name, p):
        sd[f"{name}.weight"] = np.asarray(p["scale"])
        sd[f"{name}.bias"] = np.asarray(p["bias"])

    def put_lin(name, p):
        sd[f"{name}.weight"] = np.asarray(p["w"]).T
        sd[f"{name}.bias"] = np.asarray(p["b"])

    def put_blocks(base, blocks):
        for i, p in enumerate(blocks):
            for c, b in (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3")):
                put_conv(f"{base}.{i}.{c}", p[c])
                put_bn(f"{base}.{i}.{c}.norm", p[b])
            if "shortcut" in p:
                put_conv(f"{base}.{i}.shortcut", p["shortcut"])
                put_bn(f"{base}.{i}.shortcut.norm", p["bn_sc"])

    bb = params["backbone"]
    put_conv("backbone.stem.conv1", bb["stem"]["conv1"])
    put_bn("backbone.stem.conv1.norm", bb["stem"]["bn1"])
    for s in ("res2", "res3", "res4"):
        put_blocks(f"backbone.{s}", bb[s])
    put_blocks("roi_heads.res5", params["res5"]["res5"])
    put_conv("proposal_generator.rpn_head.conv", params["rpn"]["conv"])
    put_conv("proposal_generator.rpn_head.objectness_logits",
             params["rpn"]["objectness"])
    put_conv("proposal_generator.rpn_head.anchor_deltas", params["rpn"]["deltas"])
    pr = params["predictor"]
    put_lin("roi_heads.box_predictor.cls_score", pr["cls_score"])
    put_lin("roi_heads.box_predictor.bbox_pred", pr["bbox_pred"])
    sd["roi_heads.box_predictor.cls_embedding.weight"] = np.asarray(pr["cls_embedding"])
    put_lin("roi_heads.box_predictor.fc_attr", pr["fc_attr"])
    put_lin("roi_heads.box_predictor.attr_score", pr["attr_score"])
    return sd


def _walk(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def load_c4_params(tree: dict) -> dict:
    """Either extractor's numpy pytree in the JAX layout (from
    ``detectron2_c4_to_pytree`` or ``maskrcnn_x101_to_pytree``, or JAX's
    random trees as numpy) -> the port's tree of fp32 CPU tensors: conv
    weights HWIO -> OIHW, every other leaf as it is."""
    def leaf(path, x):
        x = torch.from_numpy(np.array(x, np.float32))      # a copy
        is_conv = path[-1] == "w" and x.dim() == 4
        return x.permute(3, 2, 0, 1).contiguous() if is_conv else x
    return _walk(tree, leaf)


def c4_params_to_pytree(params: dict) -> dict:
    """Inverse of ``load_c4_params``: the port's tree -> numpy, JAX layout."""
    def leaf(path, x):
        x = torch.as_tensor(x).detach().float().cpu()
        if path[-1] == "w" and x.dim() == 4:
            x = x.permute(2, 3, 1, 0)
        return np.ascontiguousarray(x.numpy())
    return _walk(params, leaf)
