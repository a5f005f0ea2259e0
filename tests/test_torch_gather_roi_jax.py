"""The port's bank row gather (K2) and RoIPool (B6) on the CPU, held to
the JAX package on the same numpy inputs. Tolerance: none; both are copies
or maxima of the inputs, so every result must agree bit for bit.

K2 against JAX's Pallas ``rows_gather`` in interpret mode, as the JAX
package's own tests run it, on index patterns the card kernel must take.
B6 against JAX's ``ops/roi.roi_pool`` on clipped, degenerate and
max_bin-cut rois, on a randn map and on one with NaN and infinities: JAX
gives 0 for a bin that holds a NaN (``jnp.maximum`` propagates it, then
``isfinite``), and so must the plain version, the card kernel's reference."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from clg_vqa_tpu.ops.bank_gather import rows_gather as jax_rows_gather
from clg_vqa_tpu.ops.roi import roi_pool as jax_roi_pool
from clg_vqa_tpu_torch.ops.bank_gather import rows_gather, rows_gather_plain
from clg_vqa_tpu_torch.ops.roi import roi_pool
from clg_vqa_tpu_torch.ops.roi_pool import roi_pool_nhwc, roi_pool_nhwc_plain

torch.set_num_threads(1)


# ---------------------------------------------------------------- K2


def _idx(kind: str, B: int, n_rows: int, r) -> np.ndarray:
    if kind == "same":
        return np.full(B, n_rows // 2, np.int32)
    if kind == "distinct":
        return r.permutation(n_rows)[:B].astype(np.int32)
    if kind == "duplicates":                   # a few rows taken again and again
        return r.choice(r.permutation(n_rows)[:7], B).astype(np.int32)
    return r.randint(0, n_rows, B).astype(np.int32)


@pytest.mark.parametrize("kind", ["same", "distinct", "duplicates", "uniform"])
@pytest.mark.parametrize("B", [1, 37, 300])
def test_rows_gather_equals_jax_rows_gather(kind, B):
    """The port's entry and its plain version against JAX's Pallas kernel
    in interpret mode and bank[idx]."""
    r = np.random.RandomState(B)
    bank = r.randn(400, 3, 8).astype(np.float32)
    idx = _idx(kind, B, len(bank), r)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_rows_gather(jnp.asarray(bank), jnp.asarray(idx)))
    np.testing.assert_array_equal(want, bank[idx])
    tb, ti = torch.from_numpy(bank), torch.from_numpy(idx)
    np.testing.assert_array_equal(rows_gather(tb, ti).numpy(), want)
    np.testing.assert_array_equal(rows_gather_plain(tb, ti).numpy(), want)


# ---------------------------------------------------------------- B6


def edge_rois(r, H, W, stride):
    """Random rois and the edge cases: past every edge, a point, x2 < x1,
    half-pixel corners, one past the bottom-right corner and one much
    larger than max_bin bins."""
    x1, y1 = r.rand(10) * (W - 2) * stride, r.rand(10) * (H - 2) * stride
    rand = np.stack([x1, y1, x1 + r.rand(10) * W * stride / 2,
                     y1 + r.rand(10) * H * stride / 2], 1)
    special = np.asarray([
        [-5 * stride, -5 * stride, (W + 5) * stride, (H + 5) * stride],
        [3 * stride, 2 * stride, 3 * stride, 2 * stride],
        [6 * stride, 6 * stride, 2 * stride, 1 * stride],
        [2.5 * stride, 1.5 * stride, 7.5 * stride, 4.5 * stride],
        [(W - 1) * stride, (H - 1) * stride, (W + 30) * stride, (H + 30) * stride],
        [0, 0, 40 * W * stride, 40 * H * stride]])
    return np.concatenate([rand, special]).astype(np.float32)


def nan_inf_map(r, H, W, C):
    """randn with NaN, +inf and -inf: 1% of elements each at random, a
    whole column of NaN in the first half of the channels, a whole row of
    +inf in the second half and one position of -inf in every channel."""
    feat = r.randn(H, W, C).astype(np.float32)
    u = r.rand(H, W, C)
    feat[u < 0.01] = np.nan
    feat[(u >= 0.01) & (u < 0.02)] = np.inf
    feat[(u >= 0.02) & (u < 0.03)] = -np.inf
    feat[:, 5, :C // 2] = np.nan
    feat[6, :, C // 2:] = np.inf
    feat[3, W - 6, :] = -np.inf
    return feat


CASES = [((12, 20, 32), (7, 7), 8, 8), ((12, 20, 32), (3, 3), 8, 2),
         ((50, 84, 16), (14, 14), 16, 8), ((12, 20, 16), (3, 5), 4, 2),
         ((9, 30, 8), (4, 6), 4, 8)]


@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,out,stride,max_bin", CASES)
def test_roi_pool_nhwc_equals_jax(shape, out, stride, max_bin, dtype, special):
    """Clipped, degenerate and max_bin-cut rois on a randn map and on one
    with NaN and infinities: the port's NHWC entry (on the CPU, its plain
    version) gives JAX roi_pool's bits."""
    r = np.random.RandomState(sum(shape) + max_bin)
    H, W, C = shape
    feat = nan_inf_map(r, H, W, C) if special else r.randn(H, W, C).astype(np.float32)
    rois = edge_rois(r, H, W, stride)
    kw = dict(output_size=out, spatial_scale=1 / stride, max_bin=max_bin)
    ft, rt = torch.from_numpy(feat).to(dtype), torch.from_numpy(rois)
    want = jax_roi_pool(jnp.asarray(np.moveaxis(feat, -1, 0), jnp.dtype(str(dtype)[6:])),
                        jnp.asarray(rois), **kw)
    want = np.moveaxis(np.asarray(want.astype(jnp.float32)), 1, -1)
    got = roi_pool_nhwc(ft, rt, **kw)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert torch.equal(got, roi_pool_nhwc_plain(ft, rt, **kw))
    assert np.isfinite(want).all()
    if special:
        assert (want == 0).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_roi_pool_gives_jax_zeros_on_nan_and_inf(dtype):
    """The port's plain RoIPool (the card kernel's reference) against JAX
    roi_pool on a map with NaN, +inf and -inf inside bins, on rows and
    columns two bins share and between cut bins: bit for bit, a bin holding
    a NaN or +inf gives 0, and NaN between cut bins changes nothing."""
    r = np.random.RandomState(3)
    H, W, C = 12, 20, 32
    feat = nan_inf_map(r, H, W, C)
    rois = edge_rois(r, H, W, 8)
    for out, max_bin in (((7, 7), 8), ((3, 3), 2), ((14, 14), 16)):
        kw = dict(output_size=out, spatial_scale=1 / 8, max_bin=max_bin)
        want = np.asarray(jax_roi_pool(jnp.asarray(np.moveaxis(feat, -1, 0), dtype),
                                       jnp.asarray(rois), **kw).astype(jnp.float32))
        got = roi_pool(torch.from_numpy(np.moveaxis(feat, -1, 0).copy()).to(getattr(torch, dtype)),
                       torch.from_numpy(rois), **kw)
        np.testing.assert_array_equal(got.float().numpy(), want)
        assert np.isfinite(want).all() and (want == 0).any()
    # the whole-map roi at 3 x 3 bins cut to 2 columns: bins take columns
    # [0, 2), [7, 9) and [14, 16), so the NaN column 5 lies between bins
    # and the first half of the channels stays as the finite maxima
    whole = torch.tensor([[0.0, 0.0, 159.0, 95.0]])
    clean = r.randn(H, W, C).astype(np.float32)
    clean[:, 5, :C // 2] = np.nan
    got = roi_pool_nhwc_plain(torch.from_numpy(clean), whole, output_size=(3, 3),
                              spatial_scale=1 / 8, max_bin=2)
    assert (got[0, :, :, :C // 2] != 0).all()
