"""Attention with the heads looped inside the kernel: CUDA kernels and their
plain PyTorch versions.

- Eval (K1): ``csrc/flat_attention.cu``, port of
  clg_vqa_tpu/ops/attention.py:fused_attention_flat (:549-593, kernel body
  ``_flat_fwd_kernel`` :385-410 at keep_t=256).
- Training (B1): ``csrc/flat_attention_train.cu``, port of
  ``fused_attention_train_flat`` (:596-634; ``_flat_fwd_kernel`` /
  ``_flat_bwd_kernel`` :385-459 via ``_attn_train_flat_fwd/_bwd``
  :495-528), a forward and a backward kernel behind an
  ``autograd.Function``.
- S-major training (B5): ``csrc/smajor_attention_train.cu``, port of
  ``fused_attention_train_smajor`` / ``fused_attention_smajor``
  (:1197-1238; ``_sm_fwd_kernel`` / ``_sm_bwd_kernel`` :1082-1144 via
  ``_attn_train_sm_fwd/_bwd`` :1153-1188): B1's device code
  (``csrc/attention_train.cuh``) on [S, B, H*hd] operands.
- Key-blocked variant: where one head's K, V (and, in the backward, the
  [S, S] tile) do not fit one block's shared memory, every wrapper here
  launches the key-blocked twin of its kernel in ``csrc/attention_train.cuh``
  (K and V staged 64 keys at a time; the backward's dq summed in a float32
  buffer allocated here). Below that limit the all-keys kernels run, bit for
  bit as before. So no S that the JAX kernels take is refused.
- Head-blocked eval (B2): ``csrc/blocked_attention.cu``, port of
  ``fused_attention`` (:135-175, body ``_attn_kernel`` :117-132), and
  head-blocked training (B3): ``csrc/blocked_attention_train.cu``, port of
  ``fused_attention_train`` (:976-1002) and ``fused_attention_train_hm``
  (:344-372; ``_train_fwd_kernel`` / ``_train_bwd_kernel`` :209-263 via
  ``_attn_train_fwd/_bwd`` :289-322): B1's device code on head-major
  [B, H, S, hd] operands.

q/k/v keep the projections' [B, S, H*hd] layout (B5: swapped to
[S, B, H*hd]; B2 and B3: split into [B, H, S, hd]) and the kernels loop
over heads themselves.
Numerics: QK^T post-scaled by 1/sqrt(hd) in fp32, additive key-side bias,
fp32 softmax, fp32 P.V accumulation, output cast to q's dtype.

Dropout (training) keeps the JAX package's u8-threshold semantics: keep an
attention probability where its 8 random bits are below
``t = round((1-rate)*256)``, and scale kept ones by 256/t in fp32. The TPU
kernel draws the bits from the TPU's own generator per grid cell; here they
come from the counter-based Philox4x32-10 generator (Salmon et al., SC'11),
keyed by the 64-bit seed and counted by (absolute sample, head, query row,
key column // 16): element j takes byte j % 16 of the 16 bytes that one
Philox call returns. A mask is therefore a function of (seed, sample, head,
row, column) alone, independent of tiling and of the other samples of the
batch, and the backward replays it without storing it. The CUDA kernels
and :func:`dropout_keep_mask` compute the same bits.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448          # bytes of shared memory one H100 block may use


@functools.cache
def _eval_kernel(name: str):
    """(forward, smem_bytes) of the eval kernel ``csrc/<name>.cu``: K1's
    ``flat_attention`` or B2's ``blocked_attention``, which share one C
    interface."""
    lib = _build.load(name)
    fn = getattr(lib, f"{name}_fwd")
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    smem = getattr(lib, f"{name}_smem_bytes")
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_longlong
    return fn, smem


def _key_blocked(smem_bytes, S: int, hd: int, *which: int) -> bool:
    """Whether a launch at (S, hd) takes the key-blocked variant: the
    all-keys kernel's shared memory (``smem_bytes(S, hd, *which, blocked)``)
    does not fit one block. Raises when the key-blocked one does not fit
    either."""
    if smem_bytes(S, hd, *which, 0) <= _MAX_SMEM:
        return False
    need = smem_bytes(S, hd, *which, 1)
    if need > _MAX_SMEM:
        raise ValueError(f"S={S}, hd={hd} needs {need} bytes of shared memory "
                         f"per block even key-blocked, over the {_MAX_SMEM} "
                         f"limit")
    return True


def _check_qkv(q, k, v, num_heads: int) -> tuple[int, int, int]:
    """(B, S, hd) of [B, S, H*hd] operands of one shape and dtype."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [B, S, H*hd] shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    B, S, HD = q.shape
    if HD % num_heads:
        raise ValueError(f"H*hd={HD} is not divisible by num_heads={num_heads}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q/k/v must share one dtype")
    return B, S, HD // num_heads


def _bias2(bias: torch.Tensor, B: int, S: int) -> torch.Tensor:
    """[B, 1, 1, S]-broadcastable additive bias -> contiguous fp32 [B, S]."""
    return bias.expand(B, 1, 1, S)[:, 0, 0, :].float().contiguous()


def split_heads(x: torch.Tensor, num_heads: int, dtype) -> torch.Tensor:
    """[B, S, H*hd] -> [B, H, S, hd] in ``dtype``."""
    B, S, HD = x.shape
    return x.to(dtype).reshape(B, S, num_heads, HD // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, hd] -> [B, S, H*hd]."""
    B, H, S, hd = x.shape
    return x.transpose(1, 2).reshape(B, S, H * hd)


def fused_attention_flat_plain(q, k, v, bias, num_heads: int) -> torch.Tensor:
    """The plain PyTorch version: upcast, matmul, fp32 softmax, matmul, cast."""
    B, S, HD = q.shape
    qh, kh, vh = (split_heads(x, num_heads, torch.float32) for x in (q, k, v))
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * (
        1.0 / math.sqrt(HD // num_heads))
    scores = scores + _bias2(bias, B, S)[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    return merge_heads(torch.matmul(probs, vh)).to(q.dtype)


def _refuse_grad(name: str, train_name: str, *tensors) -> None:
    """Eval kernels have no backward: raise in grad mode when an input
    requires grad, rather than return a result that drops the gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is the eval kernel and has no backward; use "
            f"{train_name} for training, or call it under torch.no_grad()")


def _launch_eval(name: str, q, k, v, bias, B: int, S: int, num_heads: int,
                 hd: int) -> torch.Tensor:
    """Run the eval kernel ``csrc/<name>.cu`` on contiguous operands of
    its layout (K1 [B, S, H*hd], B2 [B, H, S, hd]) into a new tensor, or
    raise on what it does not take."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES or hd not in (32, 64, 128):
        raise ValueError(f"the CUDA kernel takes fp32/bf16 with hd in "
                         f"(32, 64, 128); got {q.dtype}, hd={hd}")
    fn, smem_bytes = _eval_kernel(name)
    blocked = _key_blocked(smem_bytes, S, hd)
    b2 = _bias2(bias.to(q.device), B, S)
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             b2.data_ptr(), out.data_ptr(), B, S, num_heads, hd,
             torch.cuda.current_stream(q.device).cuda_stream, int(blocked))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def fused_attention_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, num_heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd) + bias) v per head on [B, S, H*hd] operands.

    bias: additive key-side, broadcastable to [B, 1, 1, S]. CPU tensors take
    the plain version; CUDA tensors launch the kernel (fp32 or bf16,
    hd in {32, 64, 128}) or raise."""
    B, S, hd = _check_qkv(q, k, v, num_heads)
    _refuse_grad("fused_attention_flat", "fused_attention_train_flat",
                 q, k, v, bias)
    if q.device.type == "cpu":
        return fused_attention_flat_plain(q, k, v, bias, num_heads)
    out = _launch_eval("flat_attention", q.contiguous(), k.contiguous(),
                       v.contiguous(), bias, B, S, num_heads, hd)
    if B and S:
        fused_attention_flat.launches += 1
    return out


fused_attention_flat.launches = 0


# ---------------------------------------------------------------------------
# B1: flat training attention with in-kernel dropout
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo32(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the constant ``a`` times ``b`` (int64
    tensor of values in [0, 2^32)). The 64-bit product overflows int64,
    so ``b`` is split into 16-bit halves: each partial product stays
    below 2^48."""
    t_lo = a * (b & 0xFFFF)
    t_hi = a * (b >> 16)
    lo = (t_lo + ((t_hi & 0xFFFF) << 16)) & _M32
    hi = (t_hi + (t_lo >> 16)) >> 16
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, seed: int):
    """Philox4x32-10 on int64 tensors holding 32-bit counter words (any
    broadcastable shapes); returns the four 32-bit output words. The key is
    the 64-bit ``seed`` (low word first). Integer ops only, so the CPU and
    the card give the same bits."""
    k0, k1 = seed & _M32, (seed >> 32) & _M32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(dropout_rate: float) -> int:
    """The u8 keep threshold t of a dropout rate, as the JAX package's
    ``_dropout_seed`` rounds it: 256 (keep all) at rate 0, never below 1."""
    if dropout_rate <= 0.0:
        return 256
    return max(int(round((1.0 - dropout_rate) * 256.0)), 1)


def dropout_keep_mask(seed: int, B: int, H: int, S: int, keep_t: int,
                      device=None) -> torch.Tensor:
    """Bool [B, H, S, S]: the keep mask both B1 kernels realize for
    (seed, sample, head, query row, key column)."""
    dev = torch.device("cpu" if device is None else device)
    G = -(-S // 16)

    def axis(n, dim):
        shape = [1, 1, 1, 1]
        shape[dim] = n
        return torch.arange(n, device=dev, dtype=torch.int64).view(shape)

    words = philox4x32_10(axis(G, 3), axis(S, 2), axis(H, 1), axis(B, 0),
                          seed & 0xFFFFFFFFFFFFFFFF)
    w = torch.stack([x.expand(B, H, S, G) for x in words], -1)  # [B,H,S,G,4]
    shifts = torch.arange(0, 32, 8, device=dev, dtype=torch.int64)
    bits = (w[..., None] >> shifts) & 0xFF                       # [...,4,4]
    return bits.reshape(B, H, S, G * 16)[..., :S] < keep_t


def plain_probs(q, k, b2, num_heads: int, keep_t: int, seed: int | None):
    """B1's attention probabilities on the plain side, in b2's dtype (fp32,
    or fp64 for fp64 inputs): p = softmax(q k^T / sqrt(hd) + bias) [B, H, S,
    S] and the keep mask of (seed, sample, head, row, column), or None
    without dropout. b2: [B, S]."""
    B, S, HD = q.shape
    scores = torch.matmul(split_heads(q, num_heads, b2.dtype),
                          split_heads(k, num_heads, b2.dtype).transpose(-1, -2)
                          ) * (1.0 / math.sqrt(HD // num_heads))
    p = torch.softmax(scores + b2[:, None, None, :], dim=-1)
    keep = (dropout_keep_mask(seed, B, num_heads, S, keep_t, q.device)
            if keep_t < 256 else None)
    return p, keep


def apply_keep(x: torch.Tensor, keep, keep_t: int) -> torch.Tensor:
    """x where kept, rescaled by 256/t; 0 where dropped; x without a mask."""
    return x if keep is None else torch.where(keep, x * (256.0 / keep_t), 0.0)


def fused_attention_train_flat_plain(q, k, v, bias, num_heads: int, *,
                                     dropout_rate: float = 0.0,
                                     seed: int | None = None) -> torch.Tensor:
    """The plain PyTorch version of B1, differentiated by autograd: upcast
    (fp32, or fp64 for fp64 inputs), matmul, softmax, the same
    counter-based keep mask with the 256/t rescale, matmul, cast."""
    B, S, hd = _check_qkv(q, k, v, num_heads)
    t = keep_threshold(dropout_rate)
    if t < 256 and seed is None:
        raise ValueError("dropout_rate > 0 needs a seed")
    ct = torch.promote_types(q.dtype, torch.float32)
    b2 = bias.expand(B, 1, 1, S)[:, 0, 0, :].to(ct)
    p, keep = plain_probs(q, k, b2, num_heads, t, seed)
    out = torch.matmul(apply_keep(p, keep, t), split_heads(v, num_heads, ct))
    return merge_heads(out).to(q.dtype)


@functools.cache
def _train_kernels(name: str = "flat_attention_train"):
    """(forward, backward, smem_bytes) of ``csrc/<name>.cu``: B1's
    ``flat_attention_train``, B5's ``smajor_attention_train`` or B3's
    ``blocked_attention_train``, which share one C interface."""
    lib = _build.load(name)
    fwd = getattr(lib, f"{name}_fwd")
    fwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                    + [ctypes.c_float, ctypes.c_uint64, ctypes.c_void_p,
                       ctypes.c_int])
    fwd.restype = ctypes.c_int
    bwd = getattr(lib, f"{name}_bwd")
    bwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                    + [ctypes.c_float, ctypes.c_uint64, ctypes.c_void_p,
                       ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    smem = getattr(lib, f"{name}_smem_bytes")
    smem.argtypes = [ctypes.c_int] * 4
    smem.restype = ctypes.c_longlong
    return fwd, bwd, smem


def _train_seed(dropout_rate: float, seed: int | None) -> tuple[int, int]:
    """(keep threshold, 64-bit seed) of a training attention call."""
    t = keep_threshold(dropout_rate)
    if t < 256 and seed is None:
        raise ValueError("dropout_rate > 0 needs a seed")
    return t, 0 if seed is None else seed & 0xFFFFFFFFFFFFFFFF


def _check_train_cuda(q: torch.Tensor, S: int, hd: int, name: str) -> None:
    """Raise unless the CUDA training kernels of ``csrc/<name>.cu`` take
    these operands."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES or hd not in (32, 64, 128):
        raise ValueError(f"the CUDA kernels take fp32/bf16 with hd in "
                         f"(32, 64, 128); got {q.dtype}, hd={hd}")
    _, _, smem_bytes = _train_kernels(name)
    for backward in (0, 1):
        _key_blocked(smem_bytes, S, hd, backward)


def _launch_train_fwd(name: str, q, k, v, b2, out, B: int, S: int,
                      num_heads: int, keep_t: int, seed: int) -> None:
    fwd, _, smem_bytes = _train_kernels(name)
    hd = q.numel() // (B * S * num_heads)
    err = fwd(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
              b2.data_ptr(), out.data_ptr(), B, S, num_heads, hd, keep_t,
              256.0 / keep_t, seed, torch.cuda.current_stream(q.device).cuda_stream,
              int(_key_blocked(smem_bytes, S, hd, 0)))
    if err != 0:
        raise RuntimeError(f"{name} forward launch failed: CUDA error {err}")


def _launch_train_bwd(name: str, q, k, v, b2, dout, B: int, S: int,
                      num_heads: int, keep_t: int, seed: int):
    """dq, dk, dv in q's layout and the bias gradient [B, S], summed over
    heads here in a fixed order, so the bits do not vary between runs. The
    key-blocked backward also takes a float32 [B, H, S, hd] dq buffer."""
    _, bwd, smem_bytes = _train_kernels(name)
    hd = q.numel() // (B * S * num_heads)
    dout = dout.to(q.dtype).contiguous()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    f32 = dict(dtype=torch.float32, device=q.device)
    db_heads = torch.empty(B, num_heads, S, **f32)
    dq32 = (torch.empty(B, num_heads, S, hd, **f32)
            if _key_blocked(smem_bytes, S, hd, 1) else None)
    err = bwd(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
              b2.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
              dv.data_ptr(), db_heads.data_ptr(), B, S, num_heads, hd, keep_t,
              256.0 / keep_t, seed, torch.cuda.current_stream(q.device).cuda_stream,
              None if dq32 is None else dq32.data_ptr())
    if err != 0:
        raise RuntimeError(f"{name} backward launch failed: CUDA error {err}")
    return dq, dk, dv, db_heads.sum(1)


class _FlatTrainFn(torch.autograd.Function):
    """B1 on the card: the forward kernel, and the backward kernel that
    recomputes the probabilities and replays the keep mask. The bias
    gradient comes out per (sample, head) as [B, H, S] and is summed over
    heads in a fixed order."""

    @staticmethod
    def forward(ctx, q, k, v, b2, num_heads, keep_t, seed):
        B, S, _ = q.shape
        out = torch.empty_like(q)
        _launch_train_fwd("flat_attention_train", q, k, v, b2, out, B, S,
                          num_heads, keep_t, seed)
        fused_attention_train_flat.launches += 1
        ctx.save_for_backward(q, k, v, b2)
        ctx.meta = (num_heads, keep_t, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, b2 = ctx.saved_tensors
        B, S, _ = q.shape
        grads = _launch_train_bwd("flat_attention_train", q, k, v, b2, dout,
                                  B, S, *ctx.meta)
        fused_attention_train_flat.backward_launches += 1
        return (*grads, None, None, None)


def fused_attention_train_flat(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, bias: torch.Tensor,
                               num_heads: int, *, dropout_rate: float = 0.0,
                               seed: int | None = None) -> torch.Tensor:
    """Training attention on [B, S, H*hd] operands with in-kernel dropout,
    differentiable in q, k, v and bias.

    bias: additive key-side, broadcastable to [B, 1, 1, S]. seed: the
    64-bit key of the dropout stream (a host integer, so the launch needs
    no device synchronisation); required when ``dropout_rate > 0``. CPU
    tensors take the plain version; CUDA tensors launch the kernels (fp32
    or bf16, hd in {32, 64, 128}) or raise."""
    B, S, hd = _check_qkv(q, k, v, num_heads)
    t, seed = _train_seed(dropout_rate, seed)
    if q.device.type == "cpu":
        return fused_attention_train_flat_plain(
            q, k, v, bias, num_heads, dropout_rate=dropout_rate, seed=seed)
    _check_train_cuda(q, S, hd, "flat_attention_train")
    b2 = _bias2(bias.to(q.device), B, S)
    if B == 0 or S == 0:
        return torch.zeros_like(q)
    return _FlatTrainFn.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                              b2, num_heads, t, seed)


fused_attention_train_flat.launches = 0
fused_attention_train_flat.backward_launches = 0


@torch.no_grad()
def realized_keep_mask(seed: int, B: int, H: int, S: int, hd: int,
                       dropout_rate: float, device, train=None) -> torch.Tensor:
    """Bool [B, H, S, S]: the keep mask that ``train`` (a training entry on
    [B, S, H*hd] operands, :func:`fused_attention_train_flat` by default)
    realizes on ``device``, read back through its forward. With q = k = 0
    and no bias every probability is 1/S, and v one-hot on key column j
    copies p_d[..., j] into an output column, so the nonzero outputs are the
    kept entries; ceil(S/hd) calls cover every key column. On the card this
    shows the kernel's own bits, to compare with :func:`dropout_keep_mask`."""
    train = train or fused_attention_train_flat
    z = torch.zeros(B, S, H * hd, device=device)
    bias = torch.zeros(B, 1, 1, S, device=device)
    mask = torch.empty(B, H, S, S, dtype=torch.bool, device=device)
    for j0 in range(0, S, hd):
        n = min(hd, S - j0)
        v = torch.zeros(B, S, H, hd, device=device)
        cols = torch.arange(n, device=device)
        v[:, j0 + cols, :, cols] = 1.0
        o = train(z, z, v.reshape(B, S, H * hd), bias, H,
                  dropout_rate=dropout_rate, seed=seed)
        mask[..., j0:j0 + n] = (o.view(B, S, H, hd)[..., :n] != 0).transpose(1, 2)
    return mask


# ---------------------------------------------------------------------------
# B5: S-major training attention
# ---------------------------------------------------------------------------

_SM = "smajor_attention_train"


def sm_dims(S: int, B: int, HD: int, num_heads: int) -> tuple[int, int, int]:
    """(batch tile, group width, heads per group) of the TPU's S-major grid,
    or raise ValueError on the shapes clg_vqa_tpu/ops/attention.py:_sm_dims
    (:1027-1050) refuses. The CUDA kernels need no such grid, but the S-major
    route takes exactly what the JAX route takes: nothing falls back to the
    flat kernel."""
    hd = HD // num_heads
    if 128 % hd == 0:
        gh, gw = 128 // hd, 128
    elif hd % 128 == 0:
        gh, gw = 1, hd
    else:
        raise ValueError(f"sm kernel needs hd | 128 or 128 | hd, got {hd}")
    if HD % gw:
        raise ValueError(f"sm kernel needs HD % {gw} == 0, got HD={HD}")
    if num_heads % gh:
        raise ValueError(f"sm kernel needs num_heads % {gh} == 0 "
                         f"(heads per 128-lane group), got {num_heads}")
    if B % 8:
        raise ValueError(f"sm kernel needs batch % 8 == 0, got {B}")
    return 8, gw, gh


def _swap01(x: torch.Tensor) -> torch.Tensor:
    """[B, S, ...] <-> [S, B, ...] as a contiguous copy."""
    return x.transpose(0, 1).contiguous()


def smajor_attention_core_plain(qs, ks, vs, bias, num_heads: int, *,
                                dropout_rate: float = 0.0,
                                seed: int | None = None) -> torch.Tensor:
    """The plain version of B5's core on S-major operands [S, B, H*hd]:
    B1's plain math on the same values, so on one seed it equals
    :func:`fused_attention_train_flat_plain` bit for bit. Differentiated by
    autograd; returns [S, B, H*hd]."""
    out = fused_attention_train_flat_plain(
        *(_swap01(x) for x in (qs, ks, vs)), bias, num_heads,
        dropout_rate=dropout_rate, seed=seed)
    return _swap01(out)


def fused_attention_train_smajor_plain(q, k, v, bias, num_heads: int, *,
                                       dropout_rate: float = 0.0,
                                       seed: int | None = None) -> torch.Tensor:
    """The plain version of :func:`fused_attention_train_smajor`: the same
    shape rules, the operands swapped S-major, the plain core, and the
    result swapped back to [B, S, H*hd]."""
    B, S, _ = _check_qkv(q, k, v, num_heads)
    sm_dims(S, B, q.shape[-1], num_heads)
    out = smajor_attention_core_plain(*(_swap01(x) for x in (q, k, v)), bias,
                                      num_heads, dropout_rate=dropout_rate,
                                      seed=seed)
    return _swap01(out)


class _SwapSB(torch.autograd.Function):
    """The S-major entry's layout copy, [B, S, .] <-> [S, B, .], forward and
    backward, each counted in ``fused_attention_train_smajor.layout_copies``.
    XLA folds these swaps into layout bitcasts; in PyTorch they move data."""

    @staticmethod
    def forward(ctx, x):
        fused_attention_train_smajor.layout_copies += 1
        return _swap01(x)

    @staticmethod
    def backward(ctx, g):
        fused_attention_train_smajor.layout_copies += 1
        return _swap01(g)


class _SmTrainFn(torch.autograd.Function):
    """B5 on the card, on S-major operands: the forward kernel, and the
    backward kernel that recomputes the probabilities and replays the keep
    mask (clg_vqa_tpu/ops/attention.py:_attn_train_core_sm, :1147-1194)."""

    @staticmethod
    def forward(ctx, qs, ks, vs, b2, num_heads, keep_t, seed):
        S, B, _ = qs.shape
        out = torch.empty_like(qs)
        _launch_train_fwd(_SM, qs, ks, vs, b2, out, B, S, num_heads, keep_t,
                          seed)
        fused_attention_train_smajor.launches += 1
        ctx.save_for_backward(qs, ks, vs, b2)
        ctx.meta = (num_heads, keep_t, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        qs, ks, vs, b2 = ctx.saved_tensors
        S, B, _ = qs.shape
        grads = _launch_train_bwd(_SM, qs, ks, vs, b2, dout, B, S, *ctx.meta)
        fused_attention_train_smajor.backward_launches += 1
        return (*grads, None, None, None)


def smajor_attention_core(qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
                          bias: torch.Tensor, num_heads: int, *,
                          dropout_rate: float = 0.0,
                          seed: int | None = None) -> torch.Tensor:
    """B5's core on S-major operands [S, B, H*hd], differentiable in qs, ks,
    vs and bias (key-side, broadcastable to [B, 1, 1, S]): the kernels for
    CUDA tensors, the plain version for CPU tensors. Returns [S, B, H*hd]."""
    S, B, hd = _check_qkv(qs, ks, vs, num_heads)
    sm_dims(S, B, qs.shape[-1], num_heads)
    t, seed = _train_seed(dropout_rate, seed)
    if qs.device.type == "cpu":
        return smajor_attention_core_plain(qs, ks, vs, bias, num_heads,
                                           dropout_rate=dropout_rate, seed=seed)
    _check_train_cuda(qs, S, hd, _SM)
    b2 = _bias2(bias.to(qs.device), B, S)
    if B == 0 or S == 0:
        return torch.zeros_like(qs)
    return _SmTrainFn.apply(qs.contiguous(), ks.contiguous(), vs.contiguous(),
                            b2, num_heads, t, seed)


def fused_attention_train_smajor(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, bias: torch.Tensor,
                                 num_heads: int, *, dropout_rate: float = 0.0,
                                 seed: int | None = None) -> torch.Tensor:
    """Training attention through the S-major kernels (port of
    clg_vqa_tpu/ops/attention.py:fused_attention_train_smajor, :1197-1220):
    B1's math and dropout on q/k/v swapped to [S, B, H*hd].

    q/k/v: [B, S, H*hd]; bias: additive key-side, broadcastable to
    [B, 1, 1, S]; seed as for :func:`fused_attention_train_flat`. Shapes
    :func:`sm_dims` refuses raise ValueError. Returns [B, S, H*hd]. On the
    card the swaps are real copies (four forward, four backward, counted in
    ``layout_copies``); CPU tensors take the plain version."""
    B, S, _ = _check_qkv(q, k, v, num_heads)
    sm_dims(S, B, q.shape[-1], num_heads)
    if q.device.type == "cpu":
        return fused_attention_train_smajor_plain(
            q, k, v, bias, num_heads, dropout_rate=dropout_rate, seed=seed)
    out = smajor_attention_core(*(_SwapSB.apply(x) for x in (q, k, v)), bias,
                                num_heads, dropout_rate=dropout_rate, seed=seed)
    return _SwapSB.apply(out)


fused_attention_train_smajor.launches = 0
fused_attention_train_smajor.backward_launches = 0
fused_attention_train_smajor.layout_copies = 0


def fused_attention_smajor_plain(q, k, v, bias, num_heads: int) -> torch.Tensor:
    """The plain version of :func:`fused_attention_smajor`."""
    return fused_attention_train_smajor_plain(q, k, v, bias, num_heads)


def fused_attention_smajor(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Forward-only S-major twin (eval; clg_vqa_tpu/ops/attention.py:1223-1238):
    B5's forward kernel without dropout on [B, S, H*hd] operands swapped
    S-major and back. The model's deterministic "sm" route takes K1, as the
    JAX package's does, so only tests and chip_smoke.py call this. Like K1 it
    has no backward and raises in grad mode when an input requires grad."""
    B, S, hd = _check_qkv(q, k, v, num_heads)
    sm_dims(S, B, q.shape[-1], num_heads)
    _refuse_grad("fused_attention_smajor", "fused_attention_train_smajor",
                 q, k, v, bias)
    if q.device.type == "cpu":
        return fused_attention_smajor_plain(q, k, v, bias, num_heads)
    _check_train_cuda(q, S, hd, _SM)
    qs, ks, vs = (_swap01(x) for x in (q, k, v))
    out = torch.empty_like(qs)
    if B and S:
        _launch_train_fwd(_SM, qs, ks, vs, _bias2(bias.to(q.device), B, S),
                          out, B, S, num_heads, 256, 0)
        fused_attention_smajor.launches += 1
    return _swap01(out)


fused_attention_smajor.launches = 0


# ---------------------------------------------------------------------------
# B2 / B3: head-blocked attention on head-major [B, H, S, hd] operands
# ---------------------------------------------------------------------------

_HM = "blocked_attention_train"


def _check_hm(qh, kh, vh) -> tuple[int, int, int, int]:
    """(B, H, S, hd) of head-major operands of one shape and dtype."""
    if qh.dim() != 4 or kh.shape != qh.shape or vh.shape != qh.shape:
        raise ValueError(f"q/k/v must share one [B, H, S, hd] shape, got "
                         f"{tuple(qh.shape)} {tuple(kh.shape)} {tuple(vh.shape)}")
    if kh.dtype != qh.dtype or vh.dtype != qh.dtype:
        raise ValueError("q/k/v must share one dtype")
    return tuple(qh.shape)


def _split_hm(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, H*hd] -> contiguous [B, H, S, hd], the TPU entries' split."""
    return split_heads(x, num_heads, x.dtype).contiguous()


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Head-blocked eval attention (B2; port of
    clg_vqa_tpu/ops/attention.py:fused_attention, :135-175, kernel body
    ``_attn_kernel`` :117-132) on [B, S, H*hd] operands: heads split into
    contiguous [B, H, S, hd] copies, ``csrc/blocked_attention.cu`` over them,
    the output merged back. The TPU entry pads S to a multiple of 8 with
    -1e9 keys; a padded key's probability is exactly 0 in fp32, and the
    kernel bounds S by loop limits, so nothing is padded here.

    bias: additive key-side, broadcastable to [B, 1, 1, S]. CPU tensors take
    the plain version; CUDA tensors launch the kernel (fp32 or bf16, hd in
    {32, 64, 128}) or raise. No backward: raises in grad mode when an input
    requires grad."""
    B, S, hd = _check_qkv(q, k, v, num_heads)
    _refuse_grad("fused_attention", "fused_attention_train", q, k, v, bias)
    if q.device.type == "cpu":
        return fused_attention_flat_plain(q, k, v, bias, num_heads)
    qh, kh, vh = (_split_hm(x, num_heads) for x in (q, k, v))
    out = _launch_eval("blocked_attention", qh, kh, vh, bias, B, S, num_heads,
                       hd)
    if B and S:
        fused_attention.launches += 1
    return merge_heads(out)


fused_attention.launches = 0


def fused_attention_train_hm_plain(qh, kh, vh, bias, *,
                                   dropout_rate: float = 0.0,
                                   seed: int | None = None) -> torch.Tensor:
    """The plain version of B3 on head-major operands [B, H, S, hd]: B1's
    plain math on the same values (merged to [B, S, H*hd] and split back),
    so on one seed it equals :func:`fused_attention_train_flat_plain` bit for
    bit. Differentiated by autograd."""
    B, H, S, hd = _check_hm(qh, kh, vh)
    out = fused_attention_train_flat_plain(
        *(merge_heads(x) for x in (qh, kh, vh)), bias, H,
        dropout_rate=dropout_rate, seed=seed)
    return split_heads(out, H, out.dtype)


class _BlockedTrainFn(torch.autograd.Function):
    """B3 on the card, on contiguous head-major operands: the forward
    kernel, and the backward kernel that recomputes the probabilities and
    replays the keep mask (clg_vqa_tpu/ops/attention.py:_attn_train_core,
    :283-327). The TPU kernel sums the bias gradient over heads in its head
    grid loop (:259-263); here it comes out as [B, H, S] and is summed over
    heads 0..H-1 in a fixed order, as B1's is. Both train entries count
    their launches in ``fused_attention_train``."""

    @staticmethod
    def forward(ctx, qh, kh, vh, b2, keep_t, seed):
        B, H, S, _ = qh.shape
        out = torch.empty_like(qh)
        _launch_train_fwd(_HM, qh, kh, vh, b2, out, B, S, H, keep_t, seed)
        fused_attention_train.launches += 1
        ctx.save_for_backward(qh, kh, vh, b2)
        ctx.meta = (H, keep_t, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        qh, kh, vh, b2 = ctx.saved_tensors
        B, _, S, _ = qh.shape
        grads = _launch_train_bwd(_HM, qh, kh, vh, b2, dout, B, S, *ctx.meta)
        fused_attention_train.backward_launches += 1
        return (*grads, None, None)


def fused_attention_train_hm(qh: torch.Tensor, kh: torch.Tensor,
                             vh: torch.Tensor, bias: torch.Tensor, *,
                             dropout_rate: float = 0.0,
                             seed: int | None = None) -> torch.Tensor:
    """Head-major training entry of B3 (port of
    clg_vqa_tpu/ops/attention.py:fused_attention_train_hm, :344-372): q/k/v
    arrive pre-split as [B, H, S, hd] and the context returns [B, H, S, hd],
    differentiable in q, k, v and bias (key-side, broadcastable to
    [B, 1, 1, S]).

    Dropout as B1's: u8 threshold t, Philox keyed by (seed, absolute sample,
    head, row, column // 16), so the mask does not depend on the batch size
    (the TPU kernel seeds per grid cell, and its mask moves with the batch
    tile). seed: a host integer, required when ``dropout_rate > 0``. S is
    not padded (see :func:`fused_attention`). CPU tensors take the plain
    version; CUDA tensors launch ``csrc/blocked_attention_train.cu`` (fp32
    or bf16, hd in {32, 64, 128}) or raise."""
    B, H, S, hd = _check_hm(qh, kh, vh)
    t, seed = _train_seed(dropout_rate, seed)
    if qh.device.type == "cpu":
        return fused_attention_train_hm_plain(qh, kh, vh, bias,
                                              dropout_rate=dropout_rate,
                                              seed=seed)
    _check_train_cuda(qh, S, hd, _HM)
    b2 = _bias2(bias.to(qh.device), B, S)
    if B == 0 or S == 0:
        return torch.zeros_like(qh)
    return _BlockedTrainFn.apply(qh.contiguous(), kh.contiguous(),
                                 vh.contiguous(), b2, t, seed)


def fused_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor, num_heads: int, *,
                          dropout_rate: float = 0.0,
                          seed: int | None = None) -> torch.Tensor:
    """Head-blocked training attention (B3; port of
    clg_vqa_tpu/ops/attention.py:fused_attention_train, :976-1002) on
    [B, S, H*hd] operands: heads split into [B, H, S, hd] copies,
    :func:`fused_attention_train_hm`, the output merged back; the copies are
    differentiated by autograd. bias and seed as for
    :func:`fused_attention_train_hm`. Counters ``launches`` and
    ``backward_launches`` count B3's kernels from either entry."""
    _check_qkv(q, k, v, num_heads)
    if q.device.type == "cpu":
        return fused_attention_train_flat_plain(q, k, v, bias, num_heads,
                                                dropout_rate=dropout_rate,
                                                seed=seed)
    out = fused_attention_train_hm(*(_split_hm(x, num_heads) for x in (q, k, v)),
                                   bias, dropout_rate=dropout_rate, seed=seed)
    return merge_heads(out)


fused_attention_train.launches = 0
fused_attention_train.backward_launches = 0
