"""The X-101-FPN 100-box region-feature extractor, M3P's feature pipeline
(port of clg_vqa_tpu/models/detector/extractor_x101.py).

mmf's extract_features_vmb.py over the vqa-maskrcnn-benchmark detector with
the released detectron_model.yaml: ResNeXt-101 64x4d backbone (stride in
the 3x3, torch's max pool) with a 512-channel FPN; the input flipped BGR ->
RGB *before* the BGR means (102.9801, 115.9465, 122.7717) are subtracted,
then resized (shortest side 800, longest 1333; the reference's quirk order,
extract_features_vmb.py:147-149) and padded to one static shape; a
multi-level RPN with legacy caffe anchors and TO_REMOVE=1 boxes (1000 per
level by objectness, masked beyond each level's valid extent, one batched
fixpoint NMS(0.7) over the five levels, the top 1000 of the merged
survivors); RoIAlign 7x7 (sampling ratio 2, unaligned) on P2..P5; fc6 /
fc7 (2048); softmax over 1601 classes; per-class NMS(0.5) over shared
boxes; the top 100 by max kept confidence. Features are the post-ReLU fc6;
boxes are the raw RPN proposals divided by the image scale (the reference
exports ``output['proposals']``; the predictor's bbox_pred is in the
parameters only so released checkpoints load key-complete).

Dtypes (``X101Config.bf16``): the image, the backbone and the FPN in bf16;
the RPN head in fp32 on the fp32 cast of each level with fp32 weights (on
the card ``torch.backends.cudnn.allow_tf32`` decides whether those convs
round their operands to TF32; ``chip_smoke.py`` and the tools turn it
off); RoIAlign reads the bf16 pyramid and accumulates in fp32; fc6 and
fc7 take bf16 operands (fc7 the cast of fc6), accumulate in fp32 and add
the fp32 bias; cls_score and the softmax in fp32.

A group of ``device_batch`` images runs as one batch (JAX vmaps the
pipeline): batched convs, one RPN NMS over every image's five levels;
RoIAlign and the 1600-class selection run image by image. Entry points run
on ``cuda`` unless given ``device="cpu"``; without CUDA they raise. The
stages are ``extract.*`` ranges for torch.profiler
(``tools/profile_extract.py --detector x101``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from ... import resolve_device
from ...data.features import RegionRecord
from ...ops.nms import NEG, batched_nms_fixpoint
from . import fpn as F
from . import resnet, rpn
from .extractor import (PIXEL_MEAN_BGR, PipelinedExtractor, _placed, pad_to,
                        resize_linear, resize_shortest_edge, tree_map)


@dataclasses.dataclass
class X101Config:
    num_boxes: int = 100
    pre_nms_topk: int = 1000       # per level
    post_nms_topk_level: int = 1000  # JAX's field; read by neither pipeline
    post_nms_topk: int = 1000
    rpn_nms_thresh: float = 0.7
    pad_h: int = 800
    pad_w: int = 1344
    short: int = 800
    max_size: int = 1333
    num_classes: int = 1600
    bf16: bool = True
    # detectron_model.yaml: RESNETS.NUM_GROUPS 64 / WIDTH_PER_GROUP 4,
    # BACKBONE.OUT_CHANNELS 512 (the released checkpoint's shapes)
    groups: int = 64
    width_per_group: int = 4
    fpn_channels: int = 512
    # RoIAlign's box chunk (ops/roi.roi_align_flat): bounds the fp32 corner
    # products; bit-identical results at any value; None = unchunked
    roi_box_chunk: int | None = None


def init_x101_params(gen: torch.Generator | None = None,
                     cfg: X101Config | None = None) -> dict:
    """Random fp32 parameters (CPU tensors) of the X101 extractor at
    ``cfg``'s widths, drawn from ``gen`` (seed 0 when None), in the JAX
    pytree's nesting."""
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    cfg = cfg or X101Config()
    ch = cfg.fpn_channels

    def lin(i, o, std):
        return {"w": torch.randn(i, o, generator=gen) * std, "b": torch.zeros(o)}

    return {
        "backbone": resnet.init_backbone_x(gen, depth=101, groups=cfg.groups,
                                           width_per_group=cfg.width_per_group),
        "fpn": F.init_fpn(gen, out_channels=ch),
        "rpn": rpn.init_rpn(gen, in_channels=ch, hid_channels=ch, num_anchors=3),
        "box_head": F.init_box_head_fc(gen, in_dim=ch * 7 * 7, rep_dim=2048),
        # bbox_pred is dead on the extraction path (raw proposals are
        # exported) but present in released checkpoints
        "predictor": {"cls_score": lin(2048, 1601, 0.01),
                      "bbox_pred": lin(2048, 1601 * 4, 0.001)},
    }


@torch.no_grad()
def preprocess_x101(raw_bgr: np.ndarray, cfg: X101Config, device):
    """One raw_bgr [H, W, 3] (uint8 or float, BGR) on ``device``: flipped
    to RGB, minus the BGR means, resized, padded. Returns (img [pad_h,
    pad_w, 3] fp32, (nh, nw), (rh, rw))."""
    rh, rw = raw_bgr.shape[:2]
    nh, nw = resize_shortest_edge(rh, rw, cfg.short, cfg.max_size)
    raw = torch.from_numpy(np.ascontiguousarray(raw_bgr)).to(device)
    img = raw.flip(-1).float() - torch.tensor(PIXEL_MEAN_BGR, device=device)
    return pad_to(resize_linear(img, nh, nw), cfg.pad_h, cfg.pad_w), (nh, nw), (rh, rw)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [N, M, D] at idx [N, K] -> [N, K, D]."""
    return x.gather(1, idx[..., None].expand(*idx.shape, x.shape[-1]))


class ExtractorX101(PipelinedExtractor):
    STRIDES, SIZES = (4, 8, 16, 32, 64), (32, 64, 128, 256, 512)

    def __init__(self, params: dict, cfg: X101Config | None = None, *,
                 device="cuda"):
        self.cfg = c = cfg or X101Config()
        self.device = resolve_device(device)
        self.params = _placed(params, self.device)
        run = dict(self.params)
        if c.bf16:
            for k in ("backbone", "fpn"):
                run[k] = tree_map(lambda x: x.to(torch.bfloat16), self.params[k])
            run["box_head"] = {k: {"w": p["w"].to(torch.bfloat16), "b": p["b"]}
                               for k, p in self.params["box_head"].items()}
        self._run_params = run
        self._anchors = [torch.from_numpy(rpn.generate_anchors_caffe(
            -(-c.pad_h // stride), -(-c.pad_w // stride), stride=stride,
            sizes=(size,))).to(self.device)
            for stride, size in zip(self.STRIDES, self.SIZES)]

    def _propose(self, p: dict, pyr: list, valid_hw: torch.Tensor):
        """The RPN over the pyramid (the reference's RPNPostProcessor,
        modeling/rpn/inference.py:73-175): per level the top pre_nms_topk
        by objectness, legacy decode and clip; one fixpoint NMS over every
        image's five levels; the top post_nms_topk of the merged survivors.
        Returns (proposals [N, post, 4], scores [N, post] logits, valid
        [N, post])."""
        c = self.cfg
        n = valid_hw.shape[0]
        cand_boxes, cand_scores = [], []
        for feat, anchors, stride in zip(pyr, self._anchors, self.STRIDES):
            with record_function("extract.rpn_head"):
                obj, deltas = rpn.rpn_head(feat.float(), p["rpn"])
            vh, vw = ((valid_hw + stride - 1) // stride).unbind(1)
            cy = torch.arange(obj.shape[1], device=self.device)
            cx = torch.arange(obj.shape[2], device=self.device)
            vmask = ((cy[None, :, None, None] < vh[:, None, None, None])
                     & (cx[None, None, :, None] < vw[:, None, None, None]))
            logits = torch.where(vmask, obj, NEG).reshape(n, -1)
            k = min(c.pre_nms_topk, logits.shape[1])
            top_i = rpn.top_k_indices(logits, k)
            top_s = logits.gather(1, top_i)
            if k < c.pre_nms_topk:          # JAX pads with -inf at index 0
                top_s = torch.nn.functional.pad(top_s, (0, c.pre_nms_topk - k),
                                                value=NEG)
                top_i = torch.nn.functional.pad(top_i, (0, c.pre_nms_topk - k))
            b = rpn.decode_boxes_legacy(anchors[top_i],
                                        _rows(deltas.reshape(n, -1, 4), top_i))
            cand_boxes.append(rpn.clip_boxes_legacy(b, valid_hw[:, 0, None],
                                                    valid_hw[:, 1, None]))
            cand_scores.append(top_s)
        boxes = torch.stack(cand_boxes, 1)                      # [N, 5, K, 4]
        scores = torch.stack(cand_scores, 1)                    # [N, 5, K]
        K = c.pre_nms_topk
        keep = batched_nms_fixpoint(
            boxes.reshape(-1, K, 4), scores.reshape(-1, K), c.rpn_nms_thresh,
            valid=torch.isfinite(scores).reshape(-1, K), class_chunk=8,
            legacy=True)
        merged = torch.where(keep.view(n, -1), scores.reshape(n, -1), NEG)
        top_i = rpn.top_k_indices(merged, c.post_nms_topk)
        top_s = merged.gather(1, top_i)
        return _rows(boxes.reshape(n, -1, 4), top_i), top_s, torch.isfinite(top_s)

    @torch.no_grad()
    def _pipeline(self, images: torch.Tensor, valid_hw: torch.Tensor) -> dict:
        """images [N, pad_h, pad_w, 3] preprocessed; valid_hw [N, 2] (h, w)
        of each resized content. Returns each output with a leading N."""
        c, p = self.cfg, self._run_params
        if c.bf16:
            images = images.to(torch.bfloat16)
        with record_function("extract.backbone"):
            stages = resnet.backbone_stages(images, p["backbone"], groups=c.groups,
                                            caffe_pool=False, stride_in_1x1=False)
        with record_function("extract.fpn"):
            pyr = F.fpn(stages, p["fpn"])
        with record_function("extract.propose"):
            proposals, _, pvalid = self._propose(p, pyr, valid_hw)
        n, R = proposals.shape[:2]
        with record_function("extract.roi_align"):
            crops = torch.cat([F.multilevel_roi_align_flat(
                [lvl[i:i + 1] for lvl in pyr], proposals[i], legacy_levels=True,
                box_chunk=c.roi_box_chunk) for i in range(n)])  # [N*R, C, 7, 7]
        with record_function("extract.box_head"):
            fc6, fc7 = F.box_head_fc(crops, p["box_head"],
                                     compute_dtype=torch.bfloat16 if c.bf16 else None)
            cls = p["predictor"]["cls_score"]
            probs = torch.softmax(fc7 @ cls["w"] + cls["b"], dim=-1).view(n, R, -1)
        fc6 = fc6.view(n, R, -1)
        out = {k: [] for k in ("features", "boxes", "obj_id", "obj_conf")}
        with record_function("extract.select"):
            for i in range(n):
                order, max_conf, objects = F.select_top_by_class_nms(
                    proposals[i], probs[i], num_keep=c.num_boxes, valid=pvalid[i],
                    legacy=True)
                for k, v in (("features", fc6[i][order]),
                             ("boxes", proposals[i][order]), ("obj_id", objects),
                             ("obj_conf", max_conf)):
                    out[k].append(v)
        out = {k: torch.stack(v) for k, v in out.items()}
        out["num_valid"] = (out["obj_conf"] > 0).sum(1)
        return out

    def preprocess(self, raw_bgr: np.ndarray):
        return preprocess_x101(raw_bgr, self.cfg, self.device)

    def _finish(self, image_id, host, nh, nw, rh, rw) -> RegionRecord:
        """Boxes back to raw-image coordinates, and the record."""
        boxes = np.asarray(host["boxes"], np.float32) / (nh / rh)
        return RegionRecord(
            image_id=image_id, features=np.asarray(host["features"], np.float32),
            boxes=boxes, img_w=float(rw), img_h=float(rh),
            obj_id=host["obj_id"], obj_conf=host["obj_conf"])
