"""The port's detector ops against the JAX package on the same numpy inputs:
RoIPool (``ops/roi.roi_pool``, the plain version of B6, and B6's wrapper
``ops/roi_pool.roi_pool_nhwc`` on CPU tensors) and the fixed-shape NMS
(``ops/nms``). Tolerance: none. RoIPool is a max of the input values and NMS
returns indices, so both must agree bit for bit; the IoU matrix (float
arithmetic) is held to rtol 1e-6."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from clg_vqa_tpu.ops import nms as JN
from clg_vqa_tpu.ops.roi import roi_pool as jax_roi_pool
from clg_vqa_tpu.ops.roi_pallas import roi_pool_pallas
from clg_vqa_tpu_torch.ops import nms as TN
from clg_vqa_tpu_torch.ops.roi import roi_pool
from clg_vqa_tpu_torch.ops.roi_pool import roi_pool_nhwc, roi_pool_nhwc_plain

torch.set_num_threads(1)


def rand_boxes(r, n, H, W):
    x1 = r.rand(n) * (W - 10)
    y1 = r.rand(n) * (H - 10)
    return np.stack([x1, y1, x1 + 1 + r.rand(n) * (W - x1 - 1),
                     y1 + 1 + r.rand(n) * (H - y1 - 1)], 1).astype(np.float32)


def edge_rois(r, H, W, stride):
    """Random rois plus the edge cases: past every edge of the map,
    degenerate (a point, x2 < x1), corners on a half-pixel after scaling
    (round half to even), and one much larger than max_bin bins."""
    special = np.asarray([
        [-5 * stride, -5 * stride, (W + 5) * stride, (H + 5) * stride],
        [3 * stride, 2 * stride, 3 * stride, 2 * stride],
        [6 * stride, 6 * stride, 2 * stride, 1 * stride],
        [2.5 * stride, 1.5 * stride, 7.5 * stride, 4.5 * stride],
        [(W - 1) * stride, (H - 1) * stride, (W + 30) * stride, (H + 30) * stride],
        [0, 0, 40 * W * stride, 40 * H * stride]], np.float32)
    return np.concatenate([rand_boxes(r, 10, H * stride, W * stride), special])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,out,scale,max_bin", [
    ((5, 18, 22), (7, 7), 0.125, 8),
    ((8, 50, 84), (14, 14), 1 / 16, 8),
    ((4, 12, 20), (3, 5), 0.25, 2),
])
def test_roi_pool_equals_jax(shape, out, scale, max_bin, dtype):
    r = np.random.RandomState(5)
    C, H, W = shape
    feat = r.randn(C, H, W).astype(np.float32)
    rois = edge_rois(r, H, W, round(1 / scale))
    want = np.asarray(jax_roi_pool(jnp.asarray(feat, dtype), jnp.asarray(rois),
                                   output_size=out, spatial_scale=scale,
                                   max_bin=max_bin).astype(jnp.float32))
    ft = torch.from_numpy(feat).to(getattr(torch, dtype))
    got = roi_pool(ft, torch.from_numpy(rois), output_size=out,
                   spatial_scale=scale, max_bin=max_bin)
    assert got.dtype == ft.dtype and got.shape == (len(rois), C, *out)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert (got[len(rois) - 2] == 0).any()      # the roi past the map: empty bins
    nhwc = roi_pool_nhwc(ft.permute(1, 2, 0).contiguous(), torch.from_numpy(rois),
                         output_size=out, spatial_scale=scale, max_bin=max_bin)
    np.testing.assert_array_equal(nhwc.float().numpy(), want.transpose(0, 2, 3, 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_pool_equals_the_pallas_kernel_in_interpret_mode(dtype):
    """At a map of 8 x 16 or more the TPU entry runs its kernel (smaller maps
    fall back to the XLA op), so this holds B6's plain version to the Pallas
    body itself."""
    r = np.random.RandomState(11)
    H, W, C = 12, 20, 128
    feat = r.randn(H, W, C).astype(np.float32)
    rois = edge_rois(r, H, W, 8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(roi_pool_pallas(
            jnp.asarray(feat, dtype), jnp.asarray(rois), output_size=(7, 7),
            spatial_scale=0.125, max_bin=8).astype(jnp.float32))
    got = roi_pool_nhwc_plain(torch.from_numpy(feat).to(getattr(torch, dtype)),
                              torch.from_numpy(rois), output_size=(7, 7),
                              spatial_scale=0.125, max_bin=8)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_roi_pool_nhwc_refuses_grad_mode_and_bad_shapes():
    feat = torch.randn(10, 12, 8, requires_grad=True)
    rois = torch.tensor([[0.0, 0.0, 40.0, 40.0]])
    with pytest.raises(RuntimeError, match="no backward"):
        roi_pool_nhwc(feat, rois, output_size=(2, 2), spatial_scale=0.25)
    with torch.no_grad():
        assert roi_pool_nhwc(feat, rois, output_size=(2, 2),
                             spatial_scale=0.25).shape == (1, 2, 2, 8)
    with pytest.raises(ValueError, match=r"\[H, W, C\]"):
        roi_pool_nhwc(feat.detach()[0], rois, output_size=(2, 2), spatial_scale=0.25)


def test_iou_matrix_matches_jax():
    r = np.random.RandomState(0)
    b = rand_boxes(r, 40, 100, 100)
    for legacy in (False, True):
        np.testing.assert_allclose(
            TN.iou_matrix(torch.from_numpy(b), legacy=legacy).numpy(),
            np.asarray(JN.iou_matrix(jnp.asarray(b), legacy=legacy)),
            rtol=1e-6, atol=1e-7)


def tied_scores(r, n):
    """Scores with exact ties: 0.05-spaced values, each taken by several
    boxes."""
    return (r.randint(0, 12, n) * 0.05).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "ties", "valid", "max_outputs",
                                  "legacy"])
def test_nms_equals_jax(case):
    r = np.random.RandomState(1)
    b = rand_boxes(r, 60, 80, 80)
    s = tied_scores(r, 60) if case == "ties" else r.rand(60).astype(np.float32)
    kw = {}
    if case == "valid":
        kw["valid"] = np.arange(60) % 3 != 0
    if case == "max_outputs":
        kw["max_outputs"] = 7
    if case == "legacy":
        kw["legacy"] = True
    for thresh in (0.3, 0.5, 0.7):
        ji, jk = JN.nms(jnp.asarray(b), jnp.asarray(s), thresh,
                        **{k: jnp.asarray(v) if k == "valid" else v
                           for k, v in kw.items()})
        ti, tk = TN.nms(torch.from_numpy(b), torch.from_numpy(s), thresh,
                        **{k: torch.from_numpy(v) if k == "valid" else v
                           for k, v in kw.items()})
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("shared", [True, False])
def test_batched_nms_equals_jax(shared):
    r = np.random.RandomState(3)
    C, N = 5, 40
    b = (rand_boxes(r, N, 100, 100) if shared
         else np.stack([rand_boxes(r, N, 100, 100) for _ in range(C)]))
    s = np.concatenate([tied_scores(r, N)[None], r.rand(C - 1, N)]).astype(np.float32)
    valid = np.arange(N) % 4 != 1
    for v in (None, valid):
        ji, jk = JN.batched_nms(jnp.asarray(b), jnp.asarray(s), 0.5, max_outputs=12,
                                valid=None if v is None else jnp.asarray(v))
        ti, tk = TN.batched_nms(torch.from_numpy(b), torch.from_numpy(s), 0.5,
                                max_outputs=12,
                                valid=None if v is None else torch.from_numpy(v))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("case", ["shared", "per_class", "valid", "ties",
                                  "close_scores"])
def test_batched_nms_fixpoint_equals_jax(case):
    r = np.random.RandomState(13)
    C, N = 6, 50
    b = rand_boxes(r, N, 40, 40)            # dense overlaps: long chains
    s = r.rand(C, N).astype(np.float32)
    kw = {"class_chunk": 4}
    if case == "per_class":
        b = np.stack([rand_boxes(r, N, 40, 40) for _ in range(C)])
    if case == "valid":
        kw["valid"] = np.arange(N) % 4 != 0
    if case == "ties":
        s = np.stack([tied_scores(r, N) for _ in range(C)])
    if case == "close_scores":
        b[30] = b[0] + 1.0
        s[:, 0], s[:, 30] = 0.51000, 0.51005
    want = np.asarray(JN.batched_nms_fixpoint(
        jnp.asarray(b), jnp.asarray(s), 0.5,
        **{k: jnp.asarray(v) if k == "valid" else v for k, v in kw.items()}))
    got = TN.batched_nms_fixpoint(
        torch.from_numpy(b), torch.from_numpy(s), 0.5,
        **{k: torch.from_numpy(v) if k == "valid" else v for k, v in kw.items()})
    np.testing.assert_array_equal(got.numpy(), want)
    # and it is the greedy NMS of every class
    for c in range(C):
        bc = torch.from_numpy(b[c] if b.ndim == 3 else b)
        idx, keep = TN.nms(bc, torch.from_numpy(s[c]), 0.5,
                           valid=None if "valid" not in kw
                           else torch.from_numpy(kw["valid"]))
        greedy = np.zeros(N, bool)
        greedy[idx[keep].numpy()] = True
        np.testing.assert_array_equal(got[c].numpy(), greedy)
