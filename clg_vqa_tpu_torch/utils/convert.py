"""Checkpoint ingest and export for the port's UC2, M3P and gated zoo (port
of clg_vqa_tpu/utils/convert.py:26-322: the UC2 half with raw HF XLM-R
ingest, and the M3P half with the original microsoft/M3P checkpoint's
loader; the gated zoo's VOLTA names are in utils/convert_gated.py).

Three weight formats meet here, all as plain numpy mappings:
- VOLTA state dicts (the reference's torch names, Linear weights [out, in]);
  the port's own parameters are also [out, in], so VOLTA <-> port is a
  renaming. VOLTA stores shared text/vision weights under plain and ``v_``
  names; import reads the plain names and checks the aliases, export
  writes both.
- The JAX package's params pytree (Linear weights [in, out], per-layer
  leaves stacked on a leading [L] axis; the gated model's ``sublayers`` a
  tuple): :func:`from_jax_params`, a whole JAX ``TrainState`` with its
  AdamW moments and a gradient mask: :func:`from_jax_train_state`, a
  UC2 with its pretraining heads: :func:`from_jax_pretrain`, and an M3P
  with its generation parameters: :func:`from_jax_gen_params`.
- The port's own ``state_dict`` names.
The model-level entries (:func:`from_jax_params`, :func:`from_volta`,
:func:`from_jax_train_state`) build a UC2, an M3P or a Gated by the
config's type.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..config import KimiVLConfig, M3PConfig, UC2Config
from ..models.gated import Gated, GatedConfig
from ..models.kimi_vl import KimiVL
from ..models.m3p import M3P
from ..models.m3p_gen import M3PGen
from ..models.pretrain import PretrainHeads
from ..models.uc2 import UC2
from ..train.loop import TrainState
from ..train.optim import AdamWState
from .convert_gated import volta_gated_to_state_dict


def normalize_volta_keys(sd: Mapping[str, np.ndarray], *, from_hf: bool = False,
                         layer2attn: Mapping[str, int] | None = None,
                         layer2ff: Mapping[str, int] | None = None,
                         ) -> dict[str, np.ndarray]:
    """The key remapping of the reference's ``from_pretrained``
    (volta/volta/utils.py:455-518): DDP ``module.`` prefix, gamma/beta ->
    weight/bias, HF layer -> VOLTA sublayer renumbering, roberta -> bert."""
    out: dict[str, np.ndarray] = {}
    for k, v in sd.items():
        nk = k
        if nk.startswith("module."):
            nk = nk[len("module."):]
        nk = nk.replace("gamma", "weight").replace("beta", "bias")
        if from_hf and ".layer." in nk:
            num = nk.split(".layer.")[-1].split(".")[0]
            if ".attention." in nk and layer2attn:
                nk = nk.replace(f".layer.{num}.attention.",
                                f".layer.{layer2attn[num]}.attention_")
            elif ".intermediate." in nk and layer2ff:
                nk = nk.replace(f".layer.{num}.intermediate.",
                                f".layer.{layer2ff[num]}.intermediate.")
            elif ".output." in nk and layer2ff:
                nk = nk.replace(f".layer.{num}.output.",
                                f".layer.{layer2ff[num]}.output.")
        nk = nk.replace("roberta", "bert")
        nk = nk.replace("lm_head.dense", "cls.predictions.transform.dense")
        nk = nk.replace("lm_head.layer_norm", "cls.predictions.transform.LayerNorm")
        out[nk] = np.asarray(v)
    return out


def _volta_names(num_layers: int, task_key: str
                 ) -> list[tuple[str, str, tuple[str, ...]]]:
    """(port key, VOLTA key, VOLTA alias keys) for every UC2 parameter."""
    rows: list[tuple[str, str, tuple[str, ...]]] = []

    def pair(port, volta, aliases=()):
        for suffix in ("weight", "bias"):
            rows.append((f"{port}.{suffix}", f"{volta}.{suffix}",
                         tuple(f"{a}.{suffix}" for a in aliases)))

    emb = "bert.embeddings"
    rows += [("embeddings.word", f"{emb}.word_embeddings.weight", ()),
             ("embeddings.position", f"{emb}.position_embeddings.weight", ()),
             ("embeddings.token_type",
              f"{emb}.new_token_type_embeddings.weight", ())]
    for port, volta in (("ln", "LayerNorm"), ("image", "image_embeddings"),
                        ("loc", "image_location_embeddings"),
                        ("image_ln", "image_layer_norm"),
                        ("loc_ln", "image_location_layer_norm"),
                        ("v_ln", "v_LayerNorm")):
        pair(f"embeddings.{port}", f"{emb}.{volta}")
    lyr = "bert.encoder.layer"
    for b in range(num_layers):
        a, f = f"{lyr}.{2 * b}", f"{lyr}.{2 * b + 1}"
        for port, name in (("q", "query"), ("k", "key"), ("v", "value")):
            pair(f"encoder.{b}.attn.{port}", f"{a}.attention_self.{name}",
                 (f"{a}.attention_self.v_{name}",))
        pair(f"encoder.{b}.attn.o", f"{a}.attention_output.dense",
             (f"{a}.attention_output.v_dense",))
        pair(f"encoder.{b}.ln1", f"{a}.attention_output.LayerNorm")
        pair(f"encoder.{b}.ffn.w1", f"{f}.intermediate.dense",
             (f"{f}.intermediate.v_dense",))
        pair(f"encoder.{b}.ffn.w2", f"{f}.output.dense", (f"{f}.output.v_dense",))
        pair(f"encoder.{b}.ln2", f"{f}.output.LayerNorm")
    pair("pooler", "bert.t_pooler.dense")
    clf = f"clfs_dict.{task_key}.logit_fc"
    pair("classifier.fc1", f"{clf}.0")
    pair("classifier.ln", f"{clf}.2")
    pair("classifier.fc2", f"{clf}.3")
    return rows


def volta_uc2_to_state_dict(sd: Mapping[str, np.ndarray], cfg: UC2Config,
                            task_key: str = "TASK15") -> dict[str, np.ndarray]:
    """A (normalized) VOLTA UC2 state dict -> the port's state-dict names.

    The classifier is optional (a pretrained body has none). Shared-weight
    ``v_`` aliases, where present, must equal the plain tensors."""
    out = {}
    for port, volta, aliases in _volta_names(cfg.num_layers, task_key):
        if volta not in sd:
            if port.startswith("classifier."):
                continue
            raise KeyError(f"missing {volta} in the VOLTA state dict")
        for al in aliases:
            if al in sd and not np.array_equal(sd[al], sd[volta]):
                raise ValueError(f"unshared {al} in a supposedly shared checkpoint")
        out[port] = np.asarray(sd[volta], np.float32)
    return out


def state_dict_to_volta_uc2(model, cfg=None, task_key: str = "TASK15"
                            ) -> dict[str, np.ndarray]:
    """Export for the reference stack, ``v_`` aliases included
    (clg_vqa_tpu/utils/convert.py:pytree_to_volta_uc2). ``model``: a UC2 or
    its state dict (tensors or arrays); ``cfg`` is not needed, and is taken
    for the signature the three exports share."""
    if isinstance(model, torch.nn.Module):
        model = model.state_dict()
    own = {k: np.asarray(torch.as_tensor(v).detach().cpu().numpy())
           for k, v in model.items()}
    num_layers = sum(1 for k in own if k.startswith("encoder.")
                     and k.endswith(".ln1.weight"))
    sd = {}
    for port, volta, aliases in _volta_names(num_layers, task_key):
        if port not in own and port.startswith("classifier."):
            continue
        for name in (volta, *aliases):
            sd[name] = own[port]
    return sd


def hf_xlmr_to_uc2_state_dict(sd: Mapping[str, np.ndarray], cfg: UC2Config, *,
                              seed: int = 0) -> dict[str, np.ndarray]:
    """A raw HF XLM-R state dict (``roberta.*`` names, per-layer numbering)
    -> the port's state-dict names (port of
    clg_vqa_tpu/utils/convert.py:hf_xlmr_to_uc2_pytree, :130-152), via the
    sublayer-collapse renumbering of the reference's
    conversions/convert_uc2.py:26: HF layer i is VOLTA attention sublayer 2i
    and FFN sublayer 2i+1. What the HF checkpoint lacks (image embeddings,
    pooler, classifier) keeps a fresh init from ``seed``, as the reference's
    strict=False load does.

    The fresh init enters under the plain VOLTA names only: an HF checkpoint
    carries no ``v_`` aliases, and a fresh alias beside a loaded plain
    tensor would fail the shared-weight check (the JAX function merges the
    aliases in and so raises on a checkpoint without them)."""
    L = cfg.num_layers
    norm = normalize_volta_keys(
        sd, from_hf=True,
        layer2attn={str(i): 2 * i for i in range(L)},
        layer2ff={str(i): 2 * i + 1 for i in range(L)})
    fresh = {k: v.detach().numpy()
             for k, v in UC2(cfg, device="cpu", seed=seed).state_dict().items()}
    base = {volta: fresh[port]
            for port, volta, _ in _volta_names(L, "TASK15")}
    aliases = {a for _, _, al in _volta_names(L, "TASK15") for a in al}
    merged = {**base, **{k: v for k, v in norm.items()
                         if k in base or k in aliases}}
    return volta_uc2_to_state_dict(merged, cfg)


def _m3p_names(num_layers: int, task_key: str) -> list[tuple[str, str]]:
    """(port key, VOLTA key) for every M3P parameter. VOLTA's M3P keeps the
    original module names under ``bert.encoder.``
    (clg_vqa_tpu/utils/convert.py:217-258)."""
    enc = "bert.encoder"
    rows = [("embeddings.word", f"{enc}.embeddings.weight"),
            ("embeddings.position", f"{enc}.position_embeddings.weight")]

    def pair(port, volta):
        rows.extend((f"{port}.{s}", f"{volta}.{s}") for s in ("weight", "bias"))

    pair("embeddings.ln", f"{enc}.layer_norm_emb")
    pair("embeddings.image", f"{enc}.image_embeddings.image_embeddings")
    pair("embeddings.loc", f"{enc}.image_embeddings.image_location_embeddings")
    pair("embeddings.img_ln", f"{enc}.image_embeddings.LayerNorm")
    for i in range(num_layers):
        for port, name in (("q", "q_lin"), ("k", "k_lin"), ("v", "v_lin"),
                           ("o", "out_lin")):
            pair(f"encoder.{i}.attn.{port}", f"{enc}.attentions.{i}.{name}")
        pair(f"encoder.{i}.ln1", f"{enc}.layer_norm1.{i}")
        pair(f"encoder.{i}.ffn.w1", f"{enc}.ffns.{i}.lin1")
        pair(f"encoder.{i}.ffn.w2", f"{enc}.ffns.{i}.lin2")
        pair(f"encoder.{i}.ln2", f"{enc}.layer_norm2.{i}")
    pair("pooler", f"{enc}.pooled_layer.dense")
    clf = f"clfs_dict.{task_key}.logit_fc"
    pair("classifier.fc1", f"{clf}.0")
    pair("classifier.ln", f"{clf}.2")
    pair("classifier.fc2", f"{clf}.3")
    return rows


def volta_m3p_to_state_dict(sd: Mapping[str, np.ndarray], cfg: M3PConfig,
                            task_key: str = "TASK15") -> dict[str, np.ndarray]:
    """A (normalized) VOLTA M3P state dict -> the port's state-dict names
    (port of clg_vqa_tpu/utils/convert.py:volta_m3p_to_pytree). The
    classifier is optional; only the jointfwd path's modules are read, as
    the reference's prefix-tolerant load ignores the generation heads."""
    out = {}
    for port, volta in _m3p_names(cfg.num_layers, task_key):
        if volta not in sd:
            if port.startswith("classifier."):
                continue
            raise KeyError(f"missing {volta} in the VOLTA M3P state dict")
        out[port] = np.asarray(sd[volta], np.float32)
    return out


def state_dict_to_volta_m3p(model, cfg=None, task_key: str = "TASK15"
                            ) -> dict[str, np.ndarray]:
    """Export for the reference stack (port of
    clg_vqa_tpu/utils/convert.py:pytree_to_volta_m3p). ``model``: an M3P or
    its state dict (tensors or arrays); ``cfg`` as for
    :func:`state_dict_to_volta_uc2`."""
    if isinstance(model, torch.nn.Module):
        model = model.state_dict()
    own = {k: np.asarray(torch.as_tensor(v).detach().cpu().numpy())
           for k, v in model.items()}
    num_layers = sum(1 for k in own if k.startswith("encoder.")
                     and k.endswith(".ln1.weight"))
    names = _m3p_names(num_layers, task_key)
    missing = [port for port, _ in names
               if port not in own and not port.startswith("classifier.")]
    if missing:
        raise KeyError(f"not an M3P state dict: missing {missing[:5]}")
    return {volta: own[port] for port, volta in names if port in own}


def m3p_original_to_state_dict(sd: Mapping[str, np.ndarray], cfg: M3PConfig,
                               *, seed: int = 0) -> dict[str, np.ndarray]:
    """An original microsoft/M3P checkpoint (``module.*`` names:
    attentions.N.q_lin, ffns.N.lin1, layer_norm1/2.N, image_embeddings,
    pooled_layer) -> the port's state-dict names (port of
    clg_vqa_tpu/utils/convert.py:m3p_original_to_pytree, :261-278). VOLTA's
    M3P keeps the original module names, so the body maps by the
    ``module.`` -> ``bert.encoder.`` prefix; what the checkpoint lacks
    (the classifier, for one) keeps a fresh port init from ``seed``."""
    norm = {"bert.encoder." + k[len("module."):]: np.asarray(v)
            for k, v in sd.items() if k.startswith("module.")}
    base = state_dict_to_volta_m3p(M3P(cfg, device="cpu", seed=seed))
    merged = {**base, **{k: v for k, v in norm.items() if k in base}}
    return volta_m3p_to_state_dict(merged, cfg)


def model_class(cfg):
    """The port model of a config: M3P for an M3PConfig, Gated for a
    GatedConfig, KimiVL for a KimiVLConfig, else UC2."""
    if isinstance(cfg, GatedConfig):
        return Gated
    if isinstance(cfg, KimiVLConfig):
        return KimiVL
    return M3P if isinstance(cfg, M3PConfig) else UC2


# the stacked [L, ...] subtrees: the encoder's, and under an M3P's ``gen``
# the cross-attention and its LayerNorm
_STACKED = ("encoder", "encoder_attn", "ln15")


def _port_leaves(path: tuple[str, ...], arr: np.ndarray):
    """(port name, array) for one leaf of a JAX UC2, M3P, gated,
    pretraining-heads or M3P ``gen`` pytree: [in, out] Linear weights
    become [out, in], a stacked [L, ...] leaf (:data:`_STACKED`) one entry
    per block."""
    def name(p):
        *mods, leaf = p
        return ".".join([*mods, {"w": "weight", "b": "bias", "scale": "weight",
                                 "bias": "bias"}.get(leaf, leaf)])

    def fix(a):
        return np.ascontiguousarray(a.T if path[-1] == "w" else a)

    if path[0] in _STACKED:
        return [(name((path[0], str(b)) + path[1:]), fix(arr[b]))
                for b in range(arr.shape[0])]
    return [(name(path), fix(arr))]


def _walk(tree, path=()):
    """(path, leaf) of a pytree of mappings and tuples; a tuple entry (the
    gated model's ``sublayers``) is named by its index."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield path, tree


def jax_params_to_state_dict(params: Mapping) -> dict[str, np.ndarray]:
    """The JAX package's UC2, M3P or gated params pytree, or a pretraining
    heads pytree (numpy leaves) -> the port's state-dict names: [in, out]
    Linear weights become [out, in], the stacked [L, ...] encoder leaves
    become one entry per block, the gated ``sublayers`` tuple
    ``sublayers.{n}``."""
    return {n: a for path, leaf in _walk(params)
            for n, a in _port_leaves(path, np.asarray(leaf, np.float32))}


def jax_mask_to_state_dict(mask: Mapping, params: Mapping
                           ) -> dict[str, np.ndarray | None]:
    """A JAX gradient-mask tree (arrays, or None for pass-through leaves)
    -> port names; the params tree gives a None leaf its port names."""
    masks = dict(_walk(mask))
    out: dict[str, np.ndarray | None] = {}
    for path, leaf in _walk(params):
        m = masks.get(path)
        for n, a in _port_leaves(path, np.asarray(
                leaf if m is None else m, np.float32)):
            out[n] = None if m is None else a
    return out


@torch.no_grad()
def load_numpy_state(model: torch.nn.Module, sd: Mapping[str, np.ndarray], *,
                     allow_missing: tuple[str, ...] = ()) -> torch.nn.Module:
    """Copy numpy arrays into the model's parameters by state-dict name.
    Every parameter must be given unless its name starts with one of
    ``allow_missing``; unknown names and shape mismatches raise."""
    own = model.state_dict()
    unknown = sorted(set(sd) - set(own))
    missing = sorted(k for k in set(own) - set(sd)
                     if not k.startswith(allow_missing))
    if unknown or missing:
        raise KeyError(f"unknown {unknown[:5]}, missing {missing[:5]}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: shape {v.shape} != {tuple(own[k].shape)}")
        own[k].copy_(torch.from_numpy(np.array(v)))   # copy: v may be read-only
    return model


def from_jax_params(params: Mapping, cfg, *, device=None) -> torch.nn.Module:
    """A port UC2, M3P or Gated (by the config's type) carrying the weights
    of a JAX params pytree of that model."""
    return load_numpy_state(model_class(cfg)(cfg, device=device),
                            jax_params_to_state_dict(params))


def from_jax_gen_params(params: Mapping, cfg: M3PConfig, *,
                        device=None) -> tuple[M3P, M3PGen]:
    """(M3P, M3PGen) carrying a JAX M3P params pytree that holds
    ``params["gen"]`` (clg_vqa_tpu/models/m3p_gen.py:init_gen_params): the
    model takes the rest, the gen module the ``gen`` subtree, its refiner
    as deep as the tuple ``gen.refiner.layers``."""
    params = dict(params)
    gen = params.pop("gen")
    model = from_jax_params(params, cfg, device=device)
    module = M3PGen(cfg, refine_layers=len(gen["refiner"]["layers"]),
                    device=device)
    return model, load_numpy_state(module, jax_params_to_state_dict(gen))


def m3p_gen_components_to_state_dict(sd: Mapping[str, np.ndarray], cfg, *,
                                     refine_layers: int = 3
                                     ) -> dict[str, np.ndarray]:
    """The M3P generation components under their transformer-level names
    (the original checkpoints' ``module.*`` inventory,
    M3PTransformerModel.state_dict()) -> :class:`M3PGen`'s state-dict names
    (port of clg_vqa_tpu/utils/convert.py:m3p_gen_components_to_pytree,
    :325-407): per-layer encoder_attn and layer_norm15, the PredLayer bias
    (its weight IS embeddings.weight, so only the bias is read), the AoA
    refiner (no output_layer key: it is deleted under do_aoa), the
    understanding heads and the first VaeEncoder / LatentDecoder pair
    (latent_transforms.0 / original_transforms.0). Weights stay [out, in],
    as the port stores them."""
    out: dict[str, np.ndarray] = {}

    def put(port, name, suffixes=("weight", "bias")):
        for s in suffixes:
            out[f"{port}.{s}"] = np.asarray(sd[f"{name}.{s}"], np.float32)

    for i in range(cfg.num_layers):
        for port, name in (("q", "q_lin"), ("k", "k_lin"), ("v", "v_lin"),
                           ("o", "out_lin")):
            put(f"encoder_attn.{i}.{port}", f"encoder_attn.{i}.{name}")
        put(f"ln15.{i}", f"layer_norm15.{i}")
    out["pred_bias"] = np.asarray(sd["pred_layer.proj.bias"], np.float32)
    out["cross_lang"] = np.asarray(sd["cross_lang_embeddings.weight"],
                                   np.float32)
    for j in range(refine_layers):
        src, dst = f"refine_embeddings.layers.{j}", f"refiner.layers.{j}"
        for n, port in enumerate("qkv"):
            put(f"{dst}.attn.{port}", f"{src}.self_attn.linears.{n}")
        put(f"{dst}.aoa", f"{src}.self_attn.aoa_layer.0")
        put(f"{dst}.ln_a", f"{src}.sublayer.0.norm")
        put(f"{dst}.ln_b", f"{src}.sublayer.1.norm")
        put(f"{dst}.ffn.w1", f"{src}.feed_forward.lin1")
        put(f"{dst}.ffn.w2", f"{src}.feed_forward.lin2")
    put("refiner.norm", "refine_embeddings.norm")
    for port, name in (("seq_relationship", "seq_relationship"),
                       ("pooler2", "pooled_layer2.dense"),
                       ("seq_relationship2", "seq_relationship2"),
                       ("mrfr", "mrfr_dense"),
                       ("obj_transform.dense", "transformer_obj.dense"),
                       ("obj_transform.ln", "transformer_obj.LayerNorm"),
                       ("obj_proj", "pred_obj_layer.proj"),
                       ("vae.x_to_mu", "latent_transforms.0.x_to_mu"),
                       ("vae.x_to_logvar", "latent_transforms.0.x_to_logvar"),
                       ("vae.out_dense", "latent_transforms.0.out_dense"),
                       ("latent_decoder.dense", "original_transforms.0.dense"),
                       ("latent_decoder.dense_mu", "original_transforms.0.dense_mu"),
                       ("latent_decoder.ln", "original_transforms.0.LayerNorm")):
        put(port, name)
    return out


def from_jax_pretrain(params: Mapping, heads: Mapping, cfg: UC2Config, *,
                      device=None) -> tuple[UC2, PretrainHeads]:
    """(UC2, PretrainHeads) carrying a JAX UC2 params pytree and its
    init_pretrain_heads pytree (clg_vqa_tpu/models/pretrain.py:31). The
    heads' ``lm`` / ``itm`` / ``img`` leaves map by name, one decoder per
    key of ``img.decoders``, the ITM width from ``itm.w``. The tied MLM
    decoder has no leaf of its own in either package: its weight is JAX's
    ``params["embeddings"]["word"]``, which becomes the UC2's
    ``embeddings.word``; only its bias, ``heads["lm"]["bias"]``, becomes the
    heads' ``lm.bias``."""
    model = from_jax_params(params, cfg, device=device)
    targets = {ix: 1.0 for ix in heads["img"]["decoders"]}
    module = PretrainHeads(cfg, itm_dim=int(np.shape(heads["itm"]["w"])[1]),
                           visual_target_weights=targets, device=device)
    return model, load_numpy_state(module, jax_params_to_state_dict(heads))


def from_volta(sd: Mapping[str, np.ndarray], cfg, *, device=None,
               task_key: str = "TASK15") -> torch.nn.Module:
    """A port UC2, M3P or Gated (by the config's type) from a VOLTA state
    dict (run :func:`normalize_volta_keys` first on raw checkpoints); a
    missing classifier keeps its fresh init."""
    if isinstance(cfg, GatedConfig):
        to_sd = volta_gated_to_state_dict
    elif isinstance(cfg, M3PConfig):
        to_sd = volta_m3p_to_state_dict
    else:
        to_sd = volta_uc2_to_state_dict
    return load_numpy_state(model_class(cfg)(cfg, device=device),
                            to_sd(sd, cfg, task_key),
                            allow_missing=("classifier.",))


def from_jax_train_state(state, cfg, *, grad_mask=None, device=None):
    """A JAX ``train.loop.TrainState`` of a UC2 or an M3P (stacked params;
    opt_state the ``make_optimizer`` chain, whose AdamW state holds
    count/mu/nu) and an
    optional JAX gradient-mask tree -> (port TrainState, port mask or None).
    The model carries the params; the AdamW moments and count become the
    port's ``AdamWState``."""
    model = from_jax_params(state.params, cfg, device=device)
    adam = [s for s in state.opt_state if "mu" in getattr(s, "_fields", ())]
    if len(adam) != 1:
        raise ValueError("opt_state holds no single AdamW state (count/mu/nu)")
    dev = model.device

    def tensors(tree):      # copies: the optimizer updates them in place
        return {k: torch.from_numpy(np.array(a)).to(dev)
                for k, a in jax_params_to_state_dict(tree).items()}

    opt_state = AdamWState(int(np.asarray(adam[0].count)),
                           tensors(adam[0].mu), tensors(adam[0].nu))
    mask = None
    if grad_mask is not None:
        mask = {k: None if a is None else torch.from_numpy(np.array(a)).to(dev)
                for k, a in jax_mask_to_state_dict(grad_mask,
                                                   state.params).items()}
    return TrainState(model, opt_state, int(np.asarray(state.step))), mask
