"""The routed experts of a mixture-of-experts layer on one expert-parallel
rank: routing, dispatch, the grouped products and the weighted combine,
with no count read back to the host.

A layer routes each token over all of the router's experts and this rank
holds ``E`` of them (``first`` .. ``first + E - 1``); it computes the part of
the layer's output that its own experts give, as one rank of an
expert-parallel layer does before the exchange. On one chip the exchange is
not run.

- :func:`route`: sigmoid scores in fp32, the top-k of scores + selection
  bias, weights ``scale * s_i / sum of the chosen s`` (the gradient flows
  through the scores, not the choice).
- :func:`dispatch`: the (token, held expert) pairs sorted by expert (a
  stable sort on the device), each expert's rows padded with zero rows to a
  multiple of ``TILE`` so that no 128-row tile spans two experts; the
  buffers have ``rows`` = T min(k, E) + E (TILE - 1) rows, the most the
  padded groups can take, plus one row that takes the pairs this rank does
  not hold. The group offsets ``poff`` stay on the device.
- :func:`routed_experts`: gather, gate|up with SwiGLU, down, and the
  weighted sum over each token's k pairs (no atomics), as one autograd
  function whose backward runs the products' gradients.

The grouped products are ``csrc/grouped_gemm.cu`` (bf16, on CUDA) with a
plain version in this module (any dtype, on the CPU); the plain version
takes the same buffers and repeats the kernel's arithmetic: bf16 operands,
fp32 accumulation, the SwiGLU in fp32 from the accumulators and one
rounding. A CUDA tensor in another dtype than bf16 raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils.profiling import count, span
from . import _build

_NAME = "grouped_gemm"
TILE = 128          # rows of a tile; each group is padded to a multiple
# the kernel launches of this process, by product
launches = {"swiglu": 0, "rows": 0, "dswiglu": 0, "wgrad": 0}


def route(logits: torch.Tensor, bias: torch.Tensor, k: int,
          scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(experts [T, k] int64, weights [T, k] fp32) of router logits [T, n]
    (sigmoid scoring, the top-k of scores + ``bias``, normalised weights
    times ``scale``; DeepSeek-V3's noaux_tc with one group)."""
    s = torch.sigmoid(logits.float())
    idx = torch.topk(s.detach() + bias, k, dim=-1).indices
    chosen = s.gather(-1, idx)
    return idx, scale * chosen / (chosen.sum(-1, keepdim=True) + 1e-20)


class Dispatch(NamedTuple):
    dest: torch.Tensor      # [T * k] int64: each pair's row (``rows`` if not held)
    token: torch.Tensor     # [T * k] int64: each pair's token
    held: torch.Tensor      # [T, k] bool
    poff: torch.Tensor      # [E + 1] int32: the padded groups' row offsets
    counts: torch.Tensor    # [E] int64: pairs each held expert takes
    pad: torch.Tensor       # [E * (TILE - 1)] int64: padding rows (or ``rows``)
    rows: int               # the buffers' rows less the pairs-not-held row
    tiles: int              # 128-row tile slots a launch walks with


def buffer_rows(T: int, k: int, E: int) -> int:
    """The most rows the padded groups of T tokens can take."""
    return T * min(k, E) + E * (TILE - 1)


def dispatch(idx: torch.Tensor, first: int, E: int,
             expected: float | None = None) -> Dispatch:
    """The pairs of ``idx`` [T, k] (router experts) that this rank holds
    (``first`` .. ``first + E - 1``), sorted by expert, in device memory.
    ``expected``: the share of pairs expected here (a launch hint: the tile
    slots cover twice as many rows, and a block walks further tiles when
    more come)."""
    T, k = idx.shape
    dev = idx.device
    local = idx - first
    held = (local >= 0) & (local < E)
    e = torch.where(held, local, E).reshape(-1)
    order = torch.sort(e, stable=True).indices
    counts = torch.zeros(E + 1, dtype=torch.int64, device=dev).scatter_add_(
        0, e, torch.ones_like(e))
    off = torch.cumsum(counts, 0) - counts
    padded = (counts[:E] + TILE - 1) // TILE * TILE
    poff = torch.cat([padded.new_zeros(1), torch.cumsum(padded, 0)])
    rows = buffer_rows(T, k, E)
    e_sorted = e[order]
    rank = torch.arange(T * k, device=dev) - off[e_sorted]
    base = torch.cat([poff[:E], poff.new_full((1,), rows)])
    dest_sorted = torch.where(e_sorted < E, base[e_sorted] + rank, rows)
    dest = torch.empty_like(dest_sorted).scatter_(0, order, dest_sorted)
    j = torch.arange(TILE - 1, device=dev)
    pad = poff[:E, None] + counts[:E, None] + j[None]
    pad = torch.where(pad < poff[1:, None], pad, rows).reshape(-1)
    token = torch.arange(T * k, device=dev) // k
    share = min(k, E) / k if expected is None else expected
    want = 2 * (T * k * share + E * TILE) / TILE
    tiles = max(1, min(rows // TILE + 1, int(want) + 1))
    return Dispatch(dest, token, held, poff.to(torch.int32), counts[:E], pad,
                    rows, tiles)


# ---------------------------------------------------------------------------
# the grouped products: plain versions
# ---------------------------------------------------------------------------

def _groups(poff: torch.Tensor) -> list[tuple[int, int]]:
    p = poff.tolist()
    return list(zip(p[:-1], p[1:]))


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated in fp32 (low-precision operands upcast: their
    products are exact)."""
    return torch.mm(a.float(), b.float())


def swiglu_plain(x, w1, poff):
    """(gu [R, 2I], act [R, I]) in x's dtype: gate | up = x w1_g^T over each
    group's rows, act = silu(gate) up from the fp32 accumulators."""
    R, I = x.shape[0], w1.shape[1] // 2
    gu = x.new_empty(R, 2 * I)
    act = x.new_empty(R, I)
    for g, (a, b) in enumerate(_groups(poff)):
        acc = _mm(x[a:b], w1[g].t())
        gu[a:b] = acc.to(x.dtype)
        act[a:b] = (torch.nn.functional.silu(acc[:, :I]) * acc[:, I:]).to(x.dtype)
    return gu, act


def rows_plain(a_, w, poff, b_kmaj: bool):
    """c [R, N] = a_ [R, K] B_g over each group's rows, B_g = w[g]^T (w [E,
    N, K], b_kmaj) or w[g] (w [E, K, N])."""
    N = w.shape[1] if b_kmaj else w.shape[2]
    c = a_.new_empty(a_.shape[0], N)
    for g, (a, b) in enumerate(_groups(poff)):
        c[a:b] = _mm(a_[a:b], w[g].t() if b_kmaj else w[g]).to(a_.dtype)
    return c


def dswiglu_plain(dy, w2, gu, poff):
    """dgu [R, 2I]: dact = dy w2_g in fp32, dgate = dact up silu'(gate),
    dup = dact silu(gate), from the kept gate and up."""
    I = w2.shape[2]
    dgu = dy.new_empty(dy.shape[0], 2 * I)
    for g, (a, b) in enumerate(_groups(poff)):
        d = _mm(dy[a:b], w2[g])
        gate, up = gu[a:b, :I].float(), gu[a:b, I:].float()
        s = torch.sigmoid(gate)
        dgu[a:b, :I] = (d * up * s * (1 + gate * (1 - s))).to(dy.dtype)
        dgu[a:b, I:] = (d * gate * s).to(dy.dtype)
    return dgu


def wgrad_plain(p, q, poff):
    """[E, M, N] fp32: p_g^T q_g over each group's rows."""
    groups = _groups(poff)
    out = torch.zeros(len(groups), p.shape[1], q.shape[1], device=p.device)
    for g, (a, b) in enumerate(groups):
        out[g] = _mm(p[a:b].t(), q[a:b])
    return out


# ---------------------------------------------------------------------------
# the grouped products: csrc/grouped_gemm.cu
# ---------------------------------------------------------------------------

@functools.cache
def _lib():
    lib = _build.load(_NAME)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.grouped_gemm_swiglu.argtypes = [P, P, P, P, P, I, LL, I, I, I, P]
    lib.grouped_gemm_rows.argtypes = [P, P, P, P, I, LL, I, I, I, I, P]
    lib.grouped_gemm_dswiglu.argtypes = [P, P, P, P, P, I, LL, I, I, I, P]
    lib.grouped_gemm_wgrad.argtypes = [P, P, P, P, I, LL, I, I, P]
    for f in (lib.grouped_gemm_swiglu, lib.grouped_gemm_rows,
              lib.grouped_gemm_dswiglu, lib.grouped_gemm_wgrad):
        f.restype = ctypes.c_int
    return lib


def _kernel(*ts: torch.Tensor) -> bool:
    """True for bf16 CUDA operands (the kernel), False for CPU ones (the
    plain version); raises for CUDA operands in another dtype."""
    if ts[0].device.type != "cuda":
        return False
    for t in ts:
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the grouped expert kernel takes contiguous bf16 "
                             "operands on 16-byte boundaries; run other "
                             "dtypes on the CPU")
    return True


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"grouped_gemm {what} launch failed: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def grouped_swiglu(x, w1, poff, tiles: int):
    """(gu, act) of the SwiGLU forward over the grouped rows of x [R, H]
    with w1 [E, 2I, H] in x's dtype."""
    if not _kernel(x, w1):
        return swiglu_plain(x, w1, poff)
    R, H = x.shape
    E, I2, _ = w1.shape
    gu = x.new_empty(R, I2)
    act = x.new_empty(R, I2 // 2)
    _check(_lib().grouped_gemm_swiglu(
        x.data_ptr(), w1.data_ptr(), gu.data_ptr(), act.data_ptr(),
        poff.data_ptr(), E, R, H, I2 // 2, tiles, _stream(x)), "swiglu")
    launches["swiglu"] += 1
    return gu, act


def grouped_rows(a, w, poff, tiles: int, b_kmaj: bool):
    """c [R, N] = a [R, K] B_g (see :func:`rows_plain`)."""
    if not _kernel(a, w):
        return rows_plain(a, w, poff, b_kmaj)
    R, K = a.shape
    N = w.shape[1] if b_kmaj else w.shape[2]
    c = a.new_empty(R, N)
    _check(_lib().grouped_gemm_rows(
        a.data_ptr(), w.data_ptr(), c.data_ptr(), poff.data_ptr(), w.shape[0],
        R, K, N, int(b_kmaj), tiles, _stream(a)), "rows")
    launches["rows"] += 1
    return c


def grouped_dswiglu(dy, w2, gu, poff, tiles: int):
    """dgu [R, 2I] (see :func:`dswiglu_plain`)."""
    if not _kernel(dy, w2, gu):
        return dswiglu_plain(dy, w2, gu, poff)
    R, H = dy.shape
    E, _, I = w2.shape
    dgu = dy.new_empty(R, 2 * I)
    _check(_lib().grouped_gemm_dswiglu(
        dy.data_ptr(), w2.data_ptr(), gu.data_ptr(), dgu.data_ptr(),
        poff.data_ptr(), E, R, H, I, tiles, _stream(dy)), "dswiglu")
    launches["dswiglu"] += 1
    return dgu


def grouped_wgrad(p, q, poff):
    """[E, M, N] fp32 (see :func:`wgrad_plain`)."""
    if not _kernel(p, q):
        return wgrad_plain(p, q, poff)
    R, M = p.shape
    N = q.shape[1]
    E = poff.shape[0] - 1
    out = torch.empty(E, M, N, device=p.device)
    _check(_lib().grouped_gemm_wgrad(
        p.data_ptr(), q.data_ptr(), out.data_ptr(), poff.data_ptr(), E, R, M,
        N, _stream(p)), "wgrad")
    launches["wgrad"] += 1
    return out


# ---------------------------------------------------------------------------
# the layer's routed part
# ---------------------------------------------------------------------------

def _rows_buffer(src: torch.Tensor, d: Dispatch) -> torch.Tensor:
    """[rows + 1, C]: src [T * k, C] at each pair's row, zero padding rows."""
    buf = src.new_empty(d.rows + 1, src.shape[1])
    # index_fill_, not buf[d.pad] = 0: that index_put_ copies the 0 from
    # the host and synchronises with the card
    buf.index_fill_(0, d.pad, 0)
    buf[d.dest] = src
    return buf


class _RoutedExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, w1, w2, d: Dispatch):
        T, k = d.held.shape
        cd = x.dtype
        w1c, w2c = w1.to(cd), w2.to(cd)
        with span("moe.dispatch"):
            xd = _rows_buffer(x[d.token], d)
        with span("moe.experts"):
            gu, act = grouped_swiglu(xd, w1c, d.poff, d.tiles)
            yd = grouped_rows(act, w2c, d.poff, d.tiles, True)
        with span("moe.combine"):
            yd[d.rows] = 0
            wm = torch.where(d.held, w, 0.0)
            out = (yd[d.dest].view(T, k, -1).float() * wm[..., None]).sum(1)
        ctx.save_for_backward(xd, gu, act, yd, wm, w1c, w2c)
        ctx.d = d
        return out

    @staticmethod
    def backward(ctx, dout):
        xd, gu, act, yd, wm, w1c, w2c = ctx.saved_tensors
        d = ctx.d
        T, k = d.held.shape
        cd = xd.dtype
        dout = dout.float()
        dw = (dout[:, None, :] * yd[d.dest].view(T, k, -1).float()).sum(-1)
        dw = torch.where(d.held, dw, 0.0)
        dyd = _rows_buffer((dout[d.token] * wm.reshape(-1, 1)).to(cd), d)
        dgu = grouped_dswiglu(dyd, w2c, gu, d.poff, d.tiles)
        dw2 = grouped_wgrad(dyd, act, d.poff)
        dxd = grouped_rows(dgu, w1c, d.poff, d.tiles, False)
        dw1 = grouped_wgrad(dgu, xd, d.poff)
        dxd[d.rows] = 0
        dx = dxd[d.dest].view(T, k, -1).float().sum(1).to(cd)
        return dx, dw, dw1, dw2, None


def routed_experts(x: torch.Tensor, w: torch.Tensor, w1: torch.Tensor,
                   w2: torch.Tensor, d: Dispatch) -> torch.Tensor:
    """[T, H] fp32: for each token the sum over its held pairs of weight x
    expert(x), expert(x) = (silu(x W1g^T) * (x W1u^T)) W2^T. ``x`` [T, H] in
    the compute dtype; ``w`` [T, k] the routing weights; ``w1`` [E, 2I, H]
    (gate rows, then up rows) and ``w2`` [E, H, I], the held experts'
    weights (fp32 masters, used in x's dtype; their gradients in fp32)."""
    count("moe.pairs", d.counts.sum())
    count("moe.largest_group", d.counts.max())
    return _RoutedExperts.apply(x, w, w1, w2, d)
