"""The R101-C4 region-feature extractor (port of
clg_vqa_tpu/models/detector/extractor.py:33-414).

``Extractor36``: the R-101-C4 + VG attribute head 36-box pipeline of
features_extraction/detectron2_proposal_maxnms.py: backbone -> RPN (300) ->
RoIPool 14x14 + res5 -> mean-pooled [300, 2048] -> class and attribute
logits -> NMS sweep to exactly 36 -> RegionRecord. Images are padded to one
static shape with the objectness masked beyond the valid feature extent;
a group of ``device_batch`` images runs as one batch (batched convs, one
NMS loop over all images).

Preprocessing: BGR pixel order, mean subtraction (102.9801, 115.9465,
122.7717), no std scaling, shortest side 800 / longest 1333, resized as
``jax.image.resize(..., "linear")`` resizes: bilinear on pixel centres with
antialiasing when shrinking (``F.interpolate(..., antialias=True)``).

``ExtractorConfig.bf16``: backbone, RPN head and res5 convs in bf16 (the
parameters cast to bf16, the predictor's cast back to fp32 as in JAX);
boxes, scores and NMS in fp32. ``use_pallas_roi`` keeps the JAX name: on a
CUDA device it selects the RoIPool kernel B6 (``ops/roi_pool.py``), where
JAX takes ``roi_pool_pallas`` on the TPU; otherwise the plain op.

Entry points run on ``cuda`` unless given ``device="cpu"``; without CUDA
they raise. The pipeline's stages are named ``extract.*`` ranges for
torch.profiler (``tools/profile_extract.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ... import resolve_device
from ...data.features import RegionRecord
from ...ops.roi_pool import roi_pool_nhwc, roi_pool_nhwc_plain
from . import heads, resnet, rpn

PIXEL_MEAN_BGR = (102.9801, 115.9465, 122.7717)


def resize_shortest_edge(h: int, w: int, short: int = 800,
                         max_size: int = 1333) -> tuple[int, int]:
    """detectron2 ResizeShortestEdge.get_output_shape."""
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def prefetch_preprocessed(preprocess_fn, items, workers: int):
    """Decode + preprocess ``items`` in a bounded thread pool, yielding
    (image_id, device_img, (nh, nw), (rh, rw)) in order. Payloads are arrays
    or zero-arg loaders (the decode then runs in a worker, overlapped with
    device work); at most 2 * workers are in flight. Items whose loader
    returns None are skipped. workers <= 0: inline."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    def prep(pair):
        raw, image_id = pair
        if callable(raw):
            raw = raw()
        if raw is None:
            return None
        img, (nh, nw), (rh, rw) = preprocess_fn(raw)
        return image_id, img, (nh, nw), (rh, rw)

    it = iter(items)
    if workers <= 0:
        for pair in it:
            got = prep(pair)
            if got is not None:
                yield got
        return
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futs: deque = deque()

        def pump():
            try:
                futs.append(pool.submit(prep, next(it)))
            except StopIteration:
                pass

        for _ in range(2 * workers):
            pump()
        while futs:
            got = futs.popleft().result()
            pump()
            if got is not None:
                yield got


def fetch_pipelined(dispatched, finish_fn, depth: int):
    """Drive ``dispatched`` (an iterator that queues device work and yields
    finish_fn argument tuples) while ``finish_fn`` (the device-to-host copy
    and host packaging) runs in one background thread, so the copy of one
    result overlaps the next one's device work. At most ``depth`` results
    wait beyond the one being fetched; results come in dispatch order."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=1) as pool:
        futs: deque = deque()
        for args in dispatched:
            futs.append(pool.submit(finish_fn, *args))
            if len(futs) > depth:
                yield futs.popleft().result()
        while futs:
            yield futs.popleft().result()


@dataclasses.dataclass
class ExtractorConfig:
    num_boxes: int = 36
    bf16: bool = True            # backbone/res5 convs in bf16 (f32 boxes/NMS)
    use_pallas_roi: bool = True  # the RoIPool kernel B6 on a CUDA device
    pooler_size: int = 14
    stride: int = 16
    pre_nms_topk: int = 6000
    post_nms_topk: int = 300
    rpn_nms_thresh: float = 0.7
    pad_h: int = 800
    pad_w: int = 1344            # 1333 rounded up to a stride multiple
    short: int = 800
    max_size: int = 1333


def init_extractor_params(gen: torch.Generator | None = None) -> dict:
    """Random fp32 parameters (CPU tensors) of the R101-C4 extractor, drawn
    from ``gen`` (seed 0 when None), in the JAX pytree's nesting."""
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    return {
        "backbone": resnet.init_backbone_c4(gen, depth=101),
        "res5": resnet.init_res5(gen, depth=101),
        "rpn": rpn.init_rpn(gen, in_channels=1024, hid_channels=512,
                            num_anchors=12),
        "predictor": heads.init_box_predictor(gen),
    }


def tree_map(fn, tree):
    """``fn`` on every tensor leaf of a nesting of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _placed(params: dict, device: torch.device, dtype=torch.float32) -> dict:
    """The tree on ``device`` in ``dtype``, conv weights channels-last (the
    layout the NHWC convs use)."""
    def put(x):
        x = torch.as_tensor(x).to(device=device, dtype=dtype)
        return (x.contiguous(memory_format=torch.channels_last) if x.dim() == 4
                else x.contiguous())
    return tree_map(put, params)


def resize_linear(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """[H, W, 3] float -> [nh, nw, 3] as ``jax.image.resize(..., "linear")``
    resizes: bilinear on pixel centres, antialiased when shrinking."""
    return F.interpolate(img.permute(2, 0, 1)[None], size=(nh, nw),
                         mode="bilinear", align_corners=False,
                         antialias=True)[0].permute(1, 2, 0)


def pad_to(img: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """img [h, w, 3] at the top left of zeros [pad_h, pad_w, 3], cut to fit."""
    pad = torch.zeros(pad_h, pad_w, 3, device=img.device)
    h, w = min(img.shape[0], pad_h), min(img.shape[1], pad_w)
    pad[:h, :w] = img[:h, :w]
    return pad


@torch.no_grad()
def preprocess(raw_bgr: np.ndarray, cfg: ExtractorConfig, device):
    """Resize, mean-subtract and pad one raw_bgr [H, W, 3] (uint8 or float,
    BGR) on ``device``; uint8 is uploaded as is and converted there. Returns
    (img [pad_h, pad_w, 3] fp32, (nh, nw), (rh, rw))."""
    rh, rw = raw_bgr.shape[:2]
    nh, nw = resize_shortest_edge(rh, rw, cfg.short, cfg.max_size)
    raw = torch.from_numpy(np.ascontiguousarray(raw_bgr)).to(device)
    img = resize_linear(raw.float(), nh, nw) - torch.tensor(PIXEL_MEAN_BGR,
                                                            device=device)
    return pad_to(img, cfg.pad_h, cfg.pad_w), (nh, nw), (rh, rw)


class PipelinedExtractor:
    """Bulk extraction shared by the detector drivers: decode and preprocess
    in a bounded thread pool, device work queued from this thread, the
    device-to-host copy and packaging in a fetch thread. Subclasses give
    ``preprocess``, ``_pipeline(images [N, H, W, 3], valid_hw [N, 2])`` and
    ``_finish(image_id, out, nh, nw, rh, rw)``."""

    def extract_many(self, items, *, depth: int = 2, device_batch: int = 1,
                     prefetch_workers: int = 2):
        """Records for (raw_bgr | loader, image_id) pairs, in order.
        ``device_batch`` images run as one batch; the last partial group is
        padded with repeats of its last image, dropped on output."""
        prepped = prefetch_preprocessed(self.preprocess, items, prefetch_workers)
        n = max(device_batch, 1)

        def flush(group):
            n_real = len(group)
            group = group + [group[-1]] * (n - n_real)
            imgs = torch.stack([g[1] for g in group])
            hw = torch.tensor([g[2] for g in group], device=imgs.device)
            return n_real, group, self._pipeline(imgs, hw)

        def dispatch():
            group = []
            for got in prepped:
                group.append(got)
                if len(group) == n:
                    yield flush(group)
                    group = []
            if group:
                yield flush(group)

        for recs in fetch_pipelined(dispatch(), self._finish_group, depth):
            yield from recs

    def extract(self, raw_bgr: np.ndarray, image_id: str) -> RegionRecord:
        """One image's record (``extract_many`` of one, inline)."""
        return next(iter(self.extract_many([(raw_bgr, image_id)],
                                           prefetch_workers=0)))

    def _finish_group(self, n_real, group, out):
        host = {k: v.cpu().numpy() for k, v in out.items()}
        recs = []
        for j in range(n_real):
            image_id, _, (nh, nw), (rh, rw) = group[j]
            recs.append(self._finish(image_id, {k: v[j] for k, v in host.items()},
                                     nh, nw, rh, rw))
        return recs


class Extractor36(PipelinedExtractor):
    def __init__(self, params: dict, cfg: ExtractorConfig | None = None, *,
                 device="cuda"):
        self.cfg = c = cfg or ExtractorConfig()
        self.device = resolve_device(device)
        self.params = _placed(params, self.device)
        if c.bf16:
            run = tree_map(lambda x: x.to(torch.bfloat16), self.params)
            run["predictor"] = tree_map(lambda x: x.float(), run["predictor"])
            self._run_params = run
        else:
            self._run_params = self.params
        self._fh, self._fw = c.pad_h // c.stride, c.pad_w // c.stride
        self._anchors = torch.from_numpy(rpn.generate_anchors(
            self._fh, self._fw, stride=c.stride)).to(self.device)
        self._pool = (roi_pool_nhwc if c.use_pallas_roi and self.device.type == "cuda"
                      else roi_pool_nhwc_plain)

    @torch.no_grad()
    def _pipeline(self, images: torch.Tensor, valid_hw: torch.Tensor) -> dict:
        """images [N, pad_h, pad_w, 3] BGR mean-subtracted; valid_hw [N, 2]
        (h, w) of each resized (unpadded) content. Returns each output with
        a leading N."""
        c, p = self.cfg, self._run_params
        if c.bf16:
            images = images.to(torch.bfloat16)
        with record_function("extract.backbone"):
            feat = resnet.backbone_c4(images, p["backbone"])    # [N, fh, fw, C]
        with record_function("extract.rpn_head"):
            obj, deltas = rpn.rpn_head(feat, p["rpn"])
        obj, deltas = obj.float(), deltas.float()
        # anchors whose cell lies beyond the valid feature extent are masked
        vh, vw = ((valid_hw + c.stride - 1) // c.stride).unbind(1)
        cy = torch.arange(self._fh, device=self.device)
        cx = torch.arange(self._fw, device=self.device)
        vmask = ((cy[None, :, None] < vh[:, None, None])
                 & (cx[None, None, :] < vw[:, None, None]))
        vmask = vmask[..., None].expand(obj.shape)
        with record_function("extract.propose"):
            boxes, _, pvalid = rpn.propose(
                obj, deltas, self._anchors, valid_hw, pre_nms_topk=c.pre_nms_topk,
                post_nms_topk=c.post_nms_topk, nms_thresh=c.rpn_nms_thresh,
                valid_mask=vmask)
        N, R = boxes.shape[:2]
        # max_bin 8 covers the C4 window (ceil(84/14) + 1)
        with record_function("extract.roi_pool"):
            crops = torch.cat([self._pool(feat[i], boxes[i],
                                          output_size=(c.pooler_size, c.pooler_size),
                                          spatial_scale=1.0 / c.stride, max_bin=8)
                               for i in range(N)])              # [N*R, 14, 14, C]
        with record_function("extract.res5"):
            pooled, _ = resnet.res5_head(crops, p["res5"], halve=False)
        pooled = pooled.float().view(N, R, -1)

        with record_function("extract.heads"):
            cls_logits, attr_logits, bdeltas = heads.box_predictor(pooled,
                                                                   p["predictor"])
        probs = torch.softmax(cls_logits, dim=-1)
        boxes_pc = heads.predict_boxes(boxes, bdeltas)          # [N, R, C, 4]
        attr_prob = torch.softmax(attr_logits[..., :-1], dim=-1)
        max_attr_label = attr_prob.argmax(-1)
        max_attr_prob = attr_prob.gather(-1, max_attr_label[..., None])[..., 0]

        with record_function("extract.select"):
            idx, keep, thresh = heads.select_exactly_n(
                boxes_pc, probs, valid_hw, n_keep=c.num_boxes, valid=pvalid)

        scores_fg = probs[..., :-1]
        max_classes = scores_fg.argmax(-1)
        max_scores = scores_fg.gather(-1, max_classes[..., None])[..., 0]
        sel_boxes = boxes_pc.gather(
            2, max_classes[..., None, None].expand(N, R, 1, 4))[:, :, 0]
        sel_boxes = rpn.clip_boxes(sel_boxes, valid_hw[:, 0, None],
                                   valid_hw[:, 1, None])

        def take(x):
            return x.gather(1, idx.view(N, -1, *([1] * (x.dim() - 2))).expand(
                N, idx.shape[1], *x.shape[2:]))

        return {"features": take(pooled), "boxes": take(sel_boxes),
                "obj_id": take(max_classes), "obj_conf": take(max_scores),
                "attr_id": take(max_attr_label), "attr_conf": take(max_attr_prob),
                "keep": keep, "nms_thresh": thresh}

    def preprocess(self, raw_bgr: np.ndarray):
        return preprocess(raw_bgr, self.cfg, self.device)

    def _finish(self, image_id, host, nh, nw, rh, rw) -> RegionRecord:
        """Boxes back to raw-image coordinates (detector_postprocess) on the
        host, and the record."""
        b = np.asarray(host["boxes"], np.float32) \
            * np.asarray([rw / nw, rh / nh, rw / nw, rh / nh], np.float32)
        np.clip(b[:, 0::2], 0.0, rw, out=b[:, 0::2])
        np.clip(b[:, 1::2], 0.0, rh, out=b[:, 1::2])
        return RegionRecord(
            image_id=image_id, features=np.asarray(host["features"], np.float32),
            boxes=b, img_w=float(rw), img_h=float(rh),
            obj_id=host["obj_id"], obj_conf=host["obj_conf"],
            attr_id=host["attr_id"], attr_conf=host["attr_conf"])



class GivenBoxExtractor:
    """Features for boxes given from outside (the reference's
    detectron2_given_box_maxnms.py): no RPN and no NMS sweep; RoIPool the
    given boxes, res5 and the predictors, in the parameters' dtype."""

    def __init__(self, params: dict, cfg: ExtractorConfig | None = None,
                 max_boxes: int = 36, *, device="cuda"):
        self._pre = Extractor36(params, cfg, device=device)   # shares preprocess
        self.cfg, self.params = self._pre.cfg, self._pre.params
        self.max_boxes = max_boxes

    @torch.no_grad()
    def _pipeline(self, image: torch.Tensor, boxes: torch.Tensor) -> dict:
        c, p = self.cfg, self.params
        feat = resnet.backbone_c4(image[None], p["backbone"])[0]
        crops = roi_pool_nhwc(feat, boxes, output_size=(c.pooler_size, c.pooler_size),
                              spatial_scale=1.0 / c.stride, max_bin=8)
        pooled, _ = resnet.res5_head(crops, p["res5"], halve=False)
        cls_logits, attr_logits, _ = heads.box_predictor(pooled, p["predictor"])
        scores_fg = torch.softmax(cls_logits, dim=-1)[:, :-1]
        attr_prob = torch.softmax(attr_logits[:, :-1], dim=-1)
        obj_id, attr_id = scores_fg.argmax(-1), attr_prob.argmax(-1)
        return {"features": pooled, "obj_id": obj_id,
                "obj_conf": scores_fg.gather(-1, obj_id[:, None])[:, 0],
                "attr_id": attr_id,
                "attr_conf": attr_prob.gather(-1, attr_id[:, None])[:, 0]}

    def extract(self, raw_bgr: np.ndarray, boxes_raw: np.ndarray,
                image_id: str) -> RegionRecord:
        """boxes_raw: [N, 4] xyxy in raw-image coordinates."""
        img, (nh, nw), (rh, rw) = self._pre.preprocess(raw_bgr)
        n = min(len(boxes_raw), self.max_boxes)
        boxes_net = np.zeros((self.max_boxes, 4), np.float32)
        boxes_net[:n] = boxes_raw[:n] * [nw / rw, nh / rh, nw / rw, nh / rh]
        out = {k: v.cpu().numpy() for k, v in self._pipeline(
            img, torch.from_numpy(boxes_net).to(img.device)).items()}
        return RegionRecord(
            image_id=image_id, features=np.asarray(out["features"][:n], np.float32),
            boxes=np.asarray(boxes_raw[:n], np.float32),
            img_w=float(rw), img_h=float(rh),
            obj_id=out["obj_id"][:n], obj_conf=out["obj_conf"][:n],
            attr_id=out["attr_id"][:n], attr_conf=out["attr_conf"][:n])
