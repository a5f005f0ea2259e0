"""Caffe-style ResNet and ResNeXt for the region-feature detectors (port of
clg_vqa_tpu/models/detector/resnet.py).

Functions on NHWC tensors, as the JAX package's: each conv views its NHWC
input as a channels-last NCHW tensor (a permute, no copy), runs
``F.conv2d`` and views the result back, so activations stay NHWC in
memory. Parameters are the JAX pytree's nesting (dicts and lists) with
torch tensors; conv weights are OIHW (the JAX tree's HWIO transposed, see
``utils/convert_detector.load_c4_params``). Frozen BatchNorm is a folded
per-channel scale and bias.

Quirks kept: stride_in_1x1 (the stride on each first block's 1x1 conv1),
the caffe max pool (3x3/2, no padding, ceil mode), and RES5HALVE=False for
the VG head (res5 at stride 1 with dilation 2). The X101 detector runs
grouped 3x3 convs (ResNeXt; grouped OIHW weights are [cout, cin/groups, k,
k]), the stride in the 3x3 and torch's max pool (3x3/2, padding 1).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]

# (depth -> blocks per stage) for res2..res5
STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def conv(x: torch.Tensor, p: Params, *, stride: int = 1,
         dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """NHWC conv with OIHW weights and torch's padding ((k-1)*dilation)//2;
    groups > 1 is ResNeXt's grouped conv."""
    k = p["w"].shape[-1]
    pad = ((k - 1) * dilation) // 2
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"], p.get("b"), stride=stride,
                 padding=pad, dilation=dilation, groups=groups)
    return y.permute(0, 2, 3, 1)


def frozen_bn(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Folded inference BN: x * scale + bias."""
    return x * p["scale"] + p["bias"]


def caffe_maxpool(x: torch.Tensor) -> torch.Tensor:
    """max_pool2d(k=3, s=2, pad=0, ceil_mode=True) on NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 0, ceil_mode=True)
    return y.permute(0, 2, 3, 1)


def bottleneck(x: torch.Tensor, p: Params, *, stride: int = 1,
               dilation: int = 1, stride_in_1x1: bool = True,
               groups: int = 1) -> torch.Tensor:
    s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
    out = F.relu(frozen_bn(conv(x, p["conv1"], stride=s1), p["bn1"]))
    out = F.relu(frozen_bn(conv(out, p["conv2"], stride=s3, dilation=dilation,
                                groups=groups), p["bn2"]))
    out = frozen_bn(conv(out, p["conv3"]), p["bn3"])
    if "shortcut" in p:
        sc = frozen_bn(conv(x, p["shortcut"], stride=stride), p["bn_sc"])
    else:
        sc = x
    return F.relu(out + sc)


def stage(x: torch.Tensor, blocks: list[Params], *, stride: int,
          dilation: int = 1, stride_in_1x1: bool = True,
          groups: int = 1) -> torch.Tensor:
    for i, bp in enumerate(blocks):
        x = bottleneck(x, bp, stride=stride if i == 0 else 1,
                       dilation=dilation, stride_in_1x1=stride_in_1x1,
                       groups=groups)
    return x


def stem(x: torch.Tensor, p: Params, *, caffe_pool: bool = True) -> torch.Tensor:
    """conv1 7x7/2 + BN + ReLU + the caffe max pool, or with
    caffe_pool=False torch's 3x3/2 max pool with padding 1 (-inf padding)."""
    x = F.relu(frozen_bn(conv(x, p["conv1"], stride=2), p["bn1"]))
    if caffe_pool:
        return caffe_maxpool(x)
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def backbone_stages(x: torch.Tensor, params: Params, *,
                    stride_in_1x1: bool = True, caffe_pool: bool = True,
                    groups: int = 1) -> tuple:
    """Stem + res2..res5 -> (C2, C3, C4, C5), the FPN's inputs.
    x: [N, H, W, 3]."""
    x = stem(x, params["stem"], caffe_pool=caffe_pool)
    kw = dict(stride_in_1x1=stride_in_1x1, groups=groups)
    c2 = stage(x, params["res2"], stride=1, **kw)
    c3 = stage(c2, params["res3"], stride=2, **kw)
    c4 = stage(c3, params["res4"], stride=2, **kw)
    return c2, c3, c4, stage(c4, params["res5"], stride=2, **kw)


def backbone_c4(x: torch.Tensor, params: Params, *,
                stride_in_1x1: bool = True) -> torch.Tensor:
    """Stem + res2..res4 -> the C4 map (stride 16). x: [N, H, W, 3]."""
    x = stem(x, params["stem"])
    x = stage(x, params["res2"], stride=1, stride_in_1x1=stride_in_1x1)
    x = stage(x, params["res3"], stride=2, stride_in_1x1=stride_in_1x1)
    return stage(x, params["res4"], stride=2, stride_in_1x1=stride_in_1x1)


def res5_head(roi_feats: torch.Tensor, params: Params, *, halve: bool = False,
              stride_in_1x1: bool = True):
    """Res5 over RoI crops [R, Ph, Pw, 1024] -> (mean-pooled [R, 2048], the
    map). halve=False (VG's RES5HALVE=False): block 1's conv1 and shortcut
    at stride 1 and every conv2 at dilation 2."""
    x = stage(roi_feats, params["res5"], stride=2 if halve else 1,
              dilation=1 if halve else 2, stride_in_1x1=stride_in_1x1)
    return x.mean(dim=(1, 2)), x


# ---------------------------------------------------------------------------
# init (random; real weights come through utils/convert_detector)
# ---------------------------------------------------------------------------

def _randn(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(*shape, generator=gen, dtype=torch.float32)


def _init_conv(gen, k: int, cin: int, cout: int, bias: bool = False) -> Params:
    p = {"w": _randn(gen, cout, cin, k, k) * (2.0 / (k * k * cin)) ** 0.5}
    if bias:
        p["b"] = torch.zeros(cout)
    return p


def _init_bn(c: int) -> Params:
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def _init_bottleneck(gen, cin: int, cmid: int, cout: int, shortcut: bool,
                     groups: int = 1) -> Params:
    p = {"conv1": _init_conv(gen, 1, cin, cmid), "bn1": _init_bn(cmid),
         "conv2": _init_conv(gen, 3, cmid // groups, cmid), "bn2": _init_bn(cmid),
         "conv3": _init_conv(gen, 1, cmid, cout), "bn3": _init_bn(cout)}
    if shortcut:
        p["shortcut"] = _init_conv(gen, 1, cin, cout)
        p["bn_sc"] = _init_bn(cout)
    return p


def init_backbone_c4(gen: torch.Generator, *, depth: int = 101) -> Params:
    n2, n3, n4, _ = STAGE_BLOCKS[depth]

    def make_stage(n, cin, cmid, cout):
        return [_init_bottleneck(gen, cin if i == 0 else cout, cmid, cout,
                                 shortcut=(i == 0)) for i in range(n)]

    return {"stem": {"conv1": _init_conv(gen, 7, 3, 64), "bn1": _init_bn(64)},
            "res2": make_stage(n2, 64, 64, 256),
            "res3": make_stage(n3, 256, 128, 512),
            "res4": make_stage(n4, 512, 256, 1024)}


def init_res5(gen: torch.Generator, *, depth: int = 101) -> Params:
    n5 = STAGE_BLOCKS[depth][3]
    return {"res5": [_init_bottleneck(gen, 1024 if i == 0 else 2048, 512, 2048,
                                      shortcut=(i == 0)) for i in range(n5)]}


def init_backbone_x(gen: torch.Generator, *, depth: int = 101, groups: int = 32,
                    width_per_group: int = 8) -> Params:
    """ResNeXt stem and res2..res5 (X-101 64x4d for the X101 extractor)."""
    n2, n3, n4, n5 = STAGE_BLOCKS[depth]
    w = groups * width_per_group          # 256 for 64x4d and 32x8d alike

    def make_stage(n, cin, cmid, cout):
        return [_init_bottleneck(gen, cin if i == 0 else cout, cmid, cout,
                                 shortcut=(i == 0), groups=groups)
                for i in range(n)]

    return {"stem": {"conv1": _init_conv(gen, 7, 3, 64), "bn1": _init_bn(64)},
            "res2": make_stage(n2, 64, w, 256),
            "res3": make_stage(n3, 256, w * 2, 512),
            "res4": make_stage(n4, 512, w * 4, 1024),
            "res5": make_stage(n5, 1024, w * 8, 2048)}
