"""The (dp, mp) mesh over torch.distributed ranks and the Megatron layout
(port of clg_vqa_tpu/parallel/mesh.py:28-90).

The reference trains with one process per GPU and apex
``DistributedDataParallel(delay_allreduce=True)`` (train_task.py:288-295);
the JAX package lays one program over a device mesh with GSPMD. Here each
process is one rank of a world laid out dp-major, as JAX's
``devices.reshape(n_dp, n_mp)``: rank = dp_rank * n_mp + mp_rank.

Axes:
  dp: data parallel. Each dp rank trains on its slice of the batch; the
      gradients are summed over dp in fp32 once a step (train/loop.py).
  mp: Megatron tensor parallel, as the JAX package's ``_pspec_for``:
      q/k/v and ffn.w1 split on their output features (column-parallel),
      o and ffn.w2 on their input features (row-parallel), the word
      embedding on the vocabulary and classifier.fc2 on the labels;
      everything else is replicated. Attention runs this rank's heads.
A dimension that mp does not divide is split as GSPMD pads it: ceil(n/mp)
rows a rank, the last rank holding fewer.

The port's weights are [out, in], so a JAX spec on a weight's out axis is
dim 0 here and one on its in axis dim 1.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist

from ..models import layers as L


class Mesh:
    """This rank's place in a dp x mp world and its two process groups: the
    ranks sharing its mp rank (``dp_group``, over which gradients are summed)
    and those sharing its dp rank (``mp_group``, over which Megatron layers
    sum). Groups are None in a single process that joined no world."""

    def __init__(self, n_dp: int, n_mp: int, rank: int, dp_group, mp_group):
        self.n_dp, self.n_mp, self.rank = n_dp, n_mp, rank
        self.dp_rank, self.mp_rank = divmod(rank, n_mp)
        self.dp_group, self.mp_group = dp_group, mp_group

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.n_dp}, mp={self.n_mp}, rank={self.rank}: "
                f"dp {self.dp_rank}, mp {self.mp_rank})")

    def shard_range(self, n: int) -> tuple[int, int]:
        """[lo, hi) of this rank's slice of a dimension of size n split over
        mp: ceil(n / mp) a rank, as GSPMD pads."""
        size = -(-n // self.n_mp)
        lo = min(self.mp_rank * size, n)
        return lo, min(lo + size, n)


def make_mesh(n_dp: int | None = None, n_mp: int = 1) -> Mesh:
    """The mesh over every rank of the world (one rank without one).
    Raises ValueError, as JAX's, when dp x mp does not tile the world.
    Every rank must call it, in the same order as any other group made."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_dp is None:
        n_dp = world // n_mp
    if n_dp < 1 or n_mp < 1 or n_dp * n_mp != world:
        raise ValueError(
            f"mesh dp={n_dp} x mp={n_mp} does not tile the {world} available "
            f"ranks (silently dropping ranks or building an empty mesh would "
            f"fail later with obscure errors)")
    if not dist.is_initialized():
        return Mesh(1, 1, 0, None, None)
    rank = dist.get_rank()
    dp_group = mp_group = None
    # new_group is collective: every rank makes every group, in one order
    for j in range(n_mp):
        g = dist.new_group([i * n_mp + j for i in range(n_dp)])
        if rank % n_mp == j:
            dp_group = g
    for i in range(n_dp):
        g = dist.new_group([i * n_mp + j for j in range(n_mp)])
        if rank // n_mp == i:
            mp_group = g
    return Mesh(n_dp, n_mp, rank, dp_group, mp_group)


def pspec(name: str) -> int | None:
    """The dimension parameter ``name`` is split on over mp, or None
    (replicated): ``_pspec_for`` (clg_vqa_tpu/parallel/mesh.py:41-61) on the
    port's names and [out, in] weights."""
    *mods, leaf = name.split(".")
    if name == "embeddings.word":
        return 0
    if len(mods) < 2:
        return None
    parent, mod = mods[-2], mods[-1]
    if (parent == "attn" and mod in ("q", "k", "v")) or (parent, mod) == (
            "ffn", "w1") or (parent, mod) == ("classifier", "fc2"):
        return 0                            # column: weight rows, bias
    if (parent == "attn" and mod == "o") or (parent, mod) == ("ffn", "w2"):
        return 1 if leaf == "weight" else None      # row: bias replicated
    return None


def param_pspecs(model: torch.nn.Module) -> dict[str, int | None]:
    """name -> split dimension or None for every parameter of a model."""
    return {n: pspec(n) for n, _ in model.named_parameters()}


def _take(v, dim: int, lo: int, hi: int):
    """A copy of v[lo:hi] along dim, for a tensor or a numpy array."""
    idx = (slice(None),) * dim + (slice(lo, hi),)
    return v[idx].clone() if isinstance(v, torch.Tensor) else v[idx].copy()


def shard_state_dict(full_sd: Mapping, mesh: Mesh) -> dict:
    """This rank's slices of a whole state dict (tensors or numpy arrays,
    e.g. ``utils/convert.from_jax_params(...).state_dict()``); None entries
    (a gradient mask's pass-through) stay None."""
    out = {}
    for k, v in full_sd.items():
        dim = pspec(k)
        if v is None or dim is None or mesh.n_mp == 1:
            out[k] = v
        else:
            out[k] = _take(v, dim, *mesh.shard_range(v.shape[dim]))
    return out


def unshard(tensors: Mapping[str, torch.Tensor],
            mesh: Mesh) -> dict[str, torch.Tensor]:
    """Whole tensors from this rank's shards, keyed by parameter name and
    cut as :func:`shard_model` cuts them: each split tensor is zero-padded
    to its whole shape (its whole size is the sum of the shards' over the
    group) and summed over the mp group; the rest are copied. Collective
    over the mp group: every rank of it must call."""
    split = [k for k in tensors if mesh.n_mp > 1 and pspec(k) is not None]
    out = {k: t.detach().clone() for k, t in tensors.items() if k not in split}
    if not split:
        return out
    sizes = L.all_reduce(torch.tensor(
        [tensors[k].shape[pspec(k)] for k in split],
        device=tensors[split[0]].device), mesh.mp_group).tolist()
    for k, n in zip(split, sizes):
        t, dim = tensors[k].detach(), pspec(k)
        full = t.new_zeros(t.shape[:dim] + (n,) + t.shape[dim + 1:])
        lo, hi = mesh.shard_range(n)
        full.narrow(dim, lo, hi - lo).copy_(t)
        out[k] = L.all_reduce(full, mesh.mp_group)
    return {k: out[k] for k in tensors}


def unshard_state_dict(model: torch.nn.Module, mesh: Mesh) -> dict:
    """The whole state dict of a model sharded by :func:`shard_model`, on
    every rank (collective over the mp group)."""
    return unshard(model.state_dict(), mesh)


def local_batch(batch: Mapping, mesh: Mesh, *, microbatched: bool = False) -> dict:
    """This rank's dp slice of a batch: [B, ...] values, or [acc, mbs, ...]
    with ``microbatched`` (the batch pspecs' counterpart). Raises when dp
    does not divide the batch."""
    dim = 1 if microbatched else 0
    out = {}
    for k, v in batch.items():
        n = v.shape[dim]
        if n % mesh.n_dp:
            raise ValueError(f"batch {n} ({k}) is not divisible by "
                             f"dp={mesh.n_dp}")
        b = n // mesh.n_dp
        idx = (slice(None),) * dim + (slice(mesh.dp_rank * b,
                                            (mesh.dp_rank + 1) * b),)
        out[k] = v[idx]
    return out


@torch.no_grad()
def shard_model(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Lay a whole UC2 or M3P (the same weights on every rank) over the
    mesh, in place: the split parameters (:func:`pspec`) keep this rank's
    slice (names unchanged, so state dicts, masks and optimizer states
    keep their keys), attention keeps num_heads / mp heads, and the model
    and every module that holds a shard record the mesh as ``mesh``, the
    layout's one source. Returns the model. Raises ValueError, as JAX's
    flat kernels under a mesh, when mp does not divide the heads."""
    if getattr(model, "mesh", None) is not None:
        raise ValueError("the model is sharded already")
    model.mesh = mesh
    if mesh.n_mp == 1:
        return model
    for m in model.modules():
        if isinstance(m, L.SelfAttention) and m.num_heads % mesh.n_mp:
            raise ValueError(f"flat attention under a mesh needs num_heads "
                             f"{m.num_heads} divisible by mp={mesh.n_mp}")
    for name, p in list(model.named_parameters()):
        dim = pspec(name)
        if dim is None:
            continue
        n = p.shape[dim]
        lo, hi = mesh.shard_range(n)
        if hi == lo:
            raise ValueError(f"{name}: {n} rows leave mp rank "
                             f"{mesh.mp_rank} of {mesh.n_mp} empty")
        owner = model.get_submodule(name.rpartition(".")[0])
        setattr(owner, name.rpartition(".")[2],
                torch.nn.Parameter(_take(p.data, dim, lo, hi),
                                   requires_grad=p.requires_grad))
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, L.Linear) and pspec(pre + "weight") is not None:
            m.mesh, m.row = mesh, pspec(pre + "weight") == 1
        elif isinstance(m, L.SelfAttention):
            m.mesh = mesh
            m.num_heads //= mesh.n_mp
        elif (isinstance(m, L.SimpleClassifier)
              and pspec(pre + "fc2.weight") is not None):
            m.mesh = mesh                       # fc2 holds a label shard
        elif pspec(pre + "word") is not None:   # the word embeddings
            m.mesh = mesh
    return model
