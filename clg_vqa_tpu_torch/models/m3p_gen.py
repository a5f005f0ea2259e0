"""M3P's generation and understanding modes (port of
clg_vqa_tpu/models/m3p_gen.py): cross-modal decode (``crossfwd``), greedy
and beam generation over a fixed-shape KV cache, the AoA image refiner, the
``predict()`` head family and the VAE latent modules
(volta/volta/m3p_transformer.py: crossfwd :966-1110, ImageEmbedding
:1112-1132, predict :1178-1209, generate :1211-1316, generate_beam
:1317-1556, AoA :272-423, VAE :501-546).

These paths share the M3P encoder's weights (models/m3p.py: the blocks'
attention, FFN and LayerNorms, the embeddings) and add the generation-only
parameters of :class:`M3PGen`: per-layer cross-attention ``encoder_attn``
and ``ln15``, the MLM bias ``pred_bias`` (the projection is TIED to
``embeddings.word``, m3p_transformer.py:727-728), ``cross_lang``, the AoA
refiner, the understanding heads and the VAE pair.

Everything runs in fp32, without dropout (the reference runs these modes
under ``torch.no_grad()`` / ``eval()``), with the reference's numerics:
q pre-scaled by 1/sqrt(hd) and -inf fill before an fp32 softmax in the XLM
attention; the refiner scales the scores after the product; post-LN
blocks with ``tensor *= mask`` after each; the causal mask is the PURE
lower triangle (get_masks :59-79: padded keys stay visible, their hidden
states are zeroed instead).

Decoding is a Python loop over a preallocated ``[L, B, H, max_len, hd]``
self-attention K/V cache written in place; the cross-attention K/V are
projected once before the loop (the reference caches them on first use,
:184-199). The beam's reorder of the self-attention cache gathers into a
second preallocated buffer, so nothing is appended or reallocated in the loop.
The loop ends one step after every row has finished (JAX's
``lax.while_loop`` ends at once): it reads that flag one step late, on
CUDA through a pinned host copy behind an event, so the host never drains
the stream, one event wait a step. Finished rows only write PAD and the
beam's hypothesis store no longer changes, so the extra step leaves the
outputs JAX's.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .. import resolve_device
from ..config import M3PConfig
from . import layers as L

EOS = 2           # XLM's eos_index (the reference's config), not a field here
NEG_INF = float("-inf")


class _CrossAttention(nn.Module):
    def __init__(self, H: int, **kw):
        super().__init__()
        self.q = L.Linear(H, H, **kw)
        self.k = L.Linear(H, H, **kw)
        self.v = L.Linear(H, H, **kw)
        self.o = L.Linear(H, H, **kw)


class _RefinerLayer(nn.Module):
    """One AoA_Refiner_Layer: pre-norm attention with the AoA gate, then a
    pre-norm GeLU FFN."""

    def __init__(self, H: int, d_ff: int, **kw):
        super().__init__()
        self.attn = nn.Module()
        self.attn.q = L.Linear(H, H, **kw)
        self.attn.k = L.Linear(H, H, **kw)
        self.attn.v = L.Linear(H, H, **kw)
        self.aoa = L.Linear(2 * H, 2 * H, **kw)
        self.ln_a = L.LayerNorm(H, 1e-12, **kw)
        self.ln_b = L.LayerNorm(H, 1e-12, **kw)
        self.ffn = L.FeedForward(H, d_ff, **kw)


class _Refiner(nn.Module):
    def __init__(self, n: int, H: int, d_ff: int, **kw):
        super().__init__()
        self.layers = nn.ModuleList(_RefinerLayer(H, d_ff, **kw)
                                    for _ in range(n))
        self.norm = L.LayerNorm(H, 1e-12, **kw)


def _group(**mods) -> nn.Module:
    m = nn.Module()
    for k, v in mods.items():
        setattr(m, k, v)
    return m


class M3PGen(nn.Module):
    """The generation-only parameters of an M3P (JAX's ``params["gen"]``,
    clg_vqa_tpu/models/m3p_gen.py:87-107), named by the JAX pytree's key
    paths: ``encoder_attn.<l>.{q,k,v,o}``, ``ln15.<l>``, ``pred_bias``,
    ``cross_lang``, ``refiner.layers.<j>.{attn.{q,k,v}, aoa, ln_a, ln_b,
    ffn.{w1,w2}}``, ``refiner.norm``, ``seq_relationship``, ``pooler2``,
    ``seq_relationship2``, ``mrfr``, ``obj_transform.{dense,ln}``,
    ``obj_proj``, ``vae.{x_to_mu,x_to_logvar,out_dense}``,
    ``latent_decoder.{dense,dense_mu,ln}``. The MLM projection has no
    weight here: it reads the M3P's ``embeddings.word``.

    Created on ``device`` (``cuda`` unless the caller passes ``"cpu"``) and
    initialized from a generator seeded with ``seed`` with JAX's
    distributions (init_gen_params): normal(0, 0.02) linears with zero
    biases and ``cross_lang``, LN scale 1 / bias 0, a zero ``pred_bias``."""

    def __init__(self, cfg: M3PConfig, *, refine_layers: int = 3, device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        kw = {"device": dev, "dtype": dtype}
        H, nL = cfg.hidden_size, cfg.num_layers
        self.cfg = cfg
        self.encoder_attn = nn.ModuleList(_CrossAttention(H, **kw)
                                          for _ in range(nL))
        self.ln15 = nn.ModuleList(L.LayerNorm(H, cfg.layer_norm_eps, **kw)
                                  for _ in range(nL))
        self.pred_bias = nn.Parameter(torch.zeros(cfg.vocab_size, **kw))
        self.cross_lang = nn.Parameter(torch.empty(2, H, **kw))
        self.refiner = _Refiner(refine_layers, H, cfg.intermediate_size, **kw)
        self.seq_relationship = L.Linear(H, 1, **kw)
        self.pooler2 = L.Linear(H, H, **kw)
        self.seq_relationship2 = L.Linear(H, 1, **kw)
        self.mrfr = L.Linear(H, 2048, **kw)
        self.obj_transform = _group(dense=L.Linear(H, H, **kw),
                                    ln=L.LayerNorm(H, 1e-12, **kw))
        self.obj_proj = L.Linear(H, 1600, **kw)
        self.vae = _group(x_to_mu=L.Linear(H, H, **kw),
                          x_to_logvar=L.Linear(H, H, **kw),
                          out_dense=L.Linear(2 * H, H, **kw))
        self.latent_decoder = _group(dense=L.Linear(H, H, **kw),
                                     dense_mu=L.Linear(H, H, **kw),
                                     ln=L.LayerNorm(H, 1e-12, **kw))
        self.init_weights(torch.Generator(dev).manual_seed(seed))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02) -> None:
        for m in self.modules():
            if isinstance(m, L.Linear):
                m.init_normal_(std, generator)
            elif isinstance(m, L.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.cross_lang.normal_(0.0, std, generator=generator)
        self.pred_bias.zero_()


# ---------------------------------------------------------------------------
# Masks + primitives
# ---------------------------------------------------------------------------

def _whole_vocabulary(model) -> None:
    """Generation runs on one device, as in the JAX package; a vocabulary
    shard (parallel/mesh.shard_model under mp > 1) is refused rather than
    gathered."""
    mesh = model.embeddings.mesh
    if mesh is not None and mesh.n_mp > 1:
        raise ValueError(
            "M3P generation needs the whole vocabulary on one device: "
            "embeddings.word is a vocabulary shard of an mp > 1 mesh")


def get_masks(slen: int, lengths: torch.Tensor, causal: bool):
    """XLM get_masks (m3p_transformer.py:59-79): (mask [B, S] bool,
    attn_mask [B, S] non-causal | [B, S, S] the pure lower triangle)."""
    alen = torch.arange(slen, device=lengths.device)
    mask = alen[None, :] < lengths[:, None]
    if causal:
        attn_mask = (alen[None, None, :] <= alen[None, :, None]).expand(
            lengths.shape[0], slen, slen)
    else:
        attn_mask = mask
    return mask, attn_mask


def _heads(t: torch.Tensor, nh: int) -> torch.Tensor:
    B, S, D = t.shape
    return t.reshape(B, S, nh, D // nh).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    B, nh, S, hd = t.shape
    return t.transpose(1, 2).reshape(B, S, nh * hd)


def _mha(x_q, kv, p, nh: int, mask) -> torch.Tensor:
    """XLM MultiHeadAttention (m3p_transformer.py:126-210): q pre-scaled by
    1/sqrt(hd), -inf where ``mask`` [B, K] or [B, Q, K] is False, fp32
    softmax."""
    hd = x_q.shape[-1] // nh
    q = _heads(p.q(x_q), nh) / math.sqrt(hd)
    k, v = _heads(p.k(kv), nh), _heads(p.v(kv), nh)
    keep = mask[:, None, None, :] if mask.dim() == 2 else mask[:, None]
    scores = torch.matmul(q, k.transpose(-1, -2)).masked_fill(~keep, NEG_INF)
    return p.o(_merge(torch.matmul(torch.softmax(scores, -1), v)))


def _ln(m: L.LayerNorm, x, eps: float):
    return L.layer_norm(x, m.weight, m.bias, eps)


# ---------------------------------------------------------------------------
# AoA refiner (m3p_transformer.py:272-423)
# ---------------------------------------------------------------------------

def aoa_refine(gen: M3PGen, x: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
    """AoA_Refiner_Core: pre-norm sublayers, a multi-head dot attention
    (scores scaled after the product) whose output feeds a GLU
    attention-on-attention gate over [ctx; query], then a GeLU FFN; a final
    LayerNorm. x [B, R, H], attn_mask [B, R] bool."""
    nh = gen.cfg.num_heads
    H = x.shape[-1]
    hd = H // nh
    keep = attn_mask[:, None, None, :]
    for lp in gen.refiner.layers:
        q_in = _ln(lp.ln_a, x, 1e-12)
        q, k, v = (_heads(m(q_in), nh) for m in (lp.attn.q, lp.attn.k, lp.attn.v))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        scores = scores.masked_fill(~keep, NEG_INF)
        ctx = _merge(torch.matmul(torch.softmax(scores, -1), v))
        g = lp.aoa(torch.cat([ctx, q_in], -1))
        x = x + g[..., :H] * torch.sigmoid(g[..., H:])
        x = x + lp.ffn(_ln(lp.ln_b, x, 1e-12))
    return _ln(gen.refiner.norm, x, 1e-12)


def image_embed_refined(model, gen: M3PGen, features, locs, lengths):
    """ImageEmbedding mode (m3p_transformer.py:1112-1132): image
    embeddings, zeroed padding slots, AoA refinement. features [B, R, 2048],
    locs [B, R, num_locs], lengths [B]. Returns (tensor [B, R, H],
    attn_mask [B, R] bool)."""
    e = model.embeddings
    img = _ln(e.img_ln, e.image(features) + e.loc(locs), model.cfg.layer_norm_eps)
    mask, attn_mask = get_masks(features.shape[1], lengths, False)
    return aoa_refine(gen, img * mask[:, :, None], attn_mask), attn_mask


# ---------------------------------------------------------------------------
# crossfwd: the text stream, whole sequence, no cache (:966-1110)
# ---------------------------------------------------------------------------

def crossfwd(model, gen: M3PGen, x: torch.Tensor, lengths: torch.Tensor, *,
             causal: bool, src_enc: torch.Tensor | None = None,
             src_len: torch.Tensor | None = None,
             positions: torch.Tensor | None = None,
             lang_id: int | None = None) -> torch.Tensor:
    """Embeddings + absolute positions (+ ``cross_lang[lang_id]``) + LN,
    then per block: self-attention (+LN1), cross-attention over
    ``src_enc`` (+LN15) only when ``causal`` and ``src_enc`` are both given
    (the decoder branch, :1083-1087), FFN (+LN2), tensor *= mask.
    x [B, S] token ids; returns [B, S, H]."""
    _whole_vocabulary(model)
    cfg = model.cfg
    e = model.embeddings
    eps, nh = cfg.layer_norm_eps, cfg.num_heads
    B, S = x.shape
    mask, attn_mask = get_masks(S, lengths, causal)
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    h = e.word[x.long()] + e.position[positions.long()]
    if lang_id is not None:
        h = h + gen.cross_lang[lang_id][None, None, :]
    h = _ln(e.ln, h, eps) * mask[:, :, None]
    if src_enc is not None:
        src_mask = (torch.arange(src_enc.shape[1], device=x.device)[None, :]
                    < src_len[:, None])
    for blk, cp, ln15 in zip(model.encoder, gen.encoder_attn, gen.ln15):
        h = _ln(blk.ln1, h + _mha(h, h, blk.attn, nh, attn_mask), eps)
        if causal and src_enc is not None:
            h = _ln(ln15, h + _mha(h, src_enc, cp, nh, src_mask), eps)
        h = _ln(blk.ln2, h + blk.ffn(h), eps) * mask[:, :, None]
    return h


# ---------------------------------------------------------------------------
# PredLayer + predict() heads (:84-123, :1178-1209)
# ---------------------------------------------------------------------------

def pred_scores(model, gen: M3PGen, h: torch.Tensor) -> torch.Tensor:
    """PredLayer.get_scores with the tied projection: h @ word^T + bias."""
    _whole_vocabulary(model)
    return torch.matmul(h, model.embeddings.word.t()) + gen.pred_bias


def mlm_loss(scores: torch.Tensor, y: torch.Tensor,
             pred_mask: torch.Tensor) -> torch.Tensor:
    """F.cross_entropy(scores[pred_mask], y, reduction='mean') at fixed
    shapes: the mean over the masked positions."""
    logp = torch.log_softmax(scores.float(), -1)
    ce = -torch.gather(logp, -1, y.long()[..., None])[..., 0]
    m = pred_mask.float()
    return (ce * m).sum() / torch.clamp(m.sum(), min=1.0)


def predict(model, gen: M3PGen, tensor: torch.Tensor, *, head: str = "mlm"):
    """The predict() head family: 'relation' (ITM over the pooler of
    position 0), 'clcm' (the second pooler pair), 'mrfr' (regression to
    2048 features), 'obj' (transform + 1600-way object head), 'mlm' (the
    tied vocabulary scores)."""
    if head == "relation":
        return gen.seq_relationship(torch.tanh(model.pooler(tensor[:, 0])))
    if head == "clcm":
        return gen.seq_relationship2(torch.tanh(gen.pooler2(tensor[:, 0])))
    if head == "mrfr":
        return gen.mrfr(tensor)
    if head == "obj":
        t = gen.obj_transform
        return gen.obj_proj(_ln(t.ln, L.gelu(t.dense(tensor)), 1e-12))
    if head == "mlm":
        return pred_scores(model, gen, tensor)
    raise ValueError(head)


# ---------------------------------------------------------------------------
# VAE latents (:501-546)
# ---------------------------------------------------------------------------

def vae_encode(gen: M3PGen, x: torch.Tensor, c: torch.Tensor, *,
               eps: torch.Tensor | None = None,
               generator: torch.Generator | None = None):
    """VaeEncoder.reparameterize. Without ``eps`` and ``generator`` the
    deterministic (eval) path: z = [mu; c] -> out_dense, KLD None. With
    either, z = mu + eps * exp(logvar / 2), ``eps`` the given standard
    normal noise or drawn from ``generator``, and the analytic KLD summed
    over axis 1 (JAX draws eps from ``jax.random``; the same eps gives the
    same output)."""
    v = gen.vae
    mu = v.x_to_mu(x)
    if eps is None and generator is None:
        return v.out_dense(torch.cat([mu, c], -1)), None
    logvar = v.x_to_logvar(x)
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                          dtype=mu.dtype)
    z = mu + eps * torch.exp(0.5 * logvar)
    kld = -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar), dim=1)
    return v.out_dense(torch.cat([z, c], -1)), kld


def latent_decode(gen: M3PGen, h: torch.Tensor) -> torch.Tensor:
    """LatentDecoder: dense -> dense_mu -> LN -> tanh."""
    d = gen.latent_decoder
    return torch.tanh(_ln(d.ln, d.dense_mu(d.dense(h)), 1e-12))


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------

class _Decoder:
    """The single-position cached decode of greedy and beam search: the
    self-attention K/V cache [L, N, nh, max_len, hd] (written in place) and
    the cross-attention K/V [L, N, nh, S_src, hd], projected once here."""

    def __init__(self, model, gen: M3PGen, src_enc, src_len, max_len: int):
        _whole_vocabulary(model)
        cfg = model.cfg
        self.model, self.gen = model, gen
        self.nh = cfg.num_heads
        self.eps = cfg.layer_norm_eps
        N, S_src, H = src_enc.shape
        hd = H // self.nh
        self.scale = math.sqrt(hd)
        self.kc = src_enc.new_zeros(cfg.num_layers, N, self.nh, max_len, hd)
        self.vc = torch.zeros_like(self.kc)
        self.ck = torch.stack([_heads(cp.k(src_enc), self.nh)
                               for cp in gen.encoder_attn])
        self.cv = torch.stack([_heads(cp.v(src_enc), self.nh)
                               for cp in gen.encoder_attn])
        self.src_keep = (torch.arange(S_src, device=src_enc.device)[None, :]
                         < src_len[:, None])[:, None, None, :]

    def step(self, tok, p: int, *, lang_vec=None, valid=None) -> torch.Tensor:
        """Hidden state [N, H] at position p for tokens ``tok`` [N]. ``valid``
        [N, 1, 1] multiplies the hidden state after the embedding LN and
        after each block (greedy's p < gen_len); ``lang_vec`` is added to
        the embedding (beam)."""
        m, nh, eps = self.model, self.nh, self.eps
        e = m.embeddings
        h = e.word[tok] + e.position[p]
        if lang_vec is not None:
            h = h + lang_vec
        h = _ln(e.ln, h[:, None, :], eps)
        if valid is not None:
            h = h * valid
        for i, (blk, cp, ln15) in enumerate(zip(m.encoder, self.gen.encoder_attn,
                                                self.gen.ln15)):
            sp = blk.attn
            q = _heads(sp.q(h), nh) / self.scale
            self.kc[i, :, :, p] = _heads(sp.k(h), nh)[:, :, 0]
            self.vc[i, :, :, p] = _heads(sp.v(h), nh)[:, :, 0]
            # keys 0..p: the causal row (the rest of the cache is masked)
            scores = torch.matmul(q, self.kc[i, :, :, :p + 1].transpose(-1, -2))
            ctx = torch.matmul(torch.softmax(scores, -1), self.vc[i, :, :, :p + 1])
            h = _ln(blk.ln1, h + sp.o(_merge(ctx)), eps)

            q = _heads(cp.q(h), nh) / self.scale
            scores = torch.matmul(q, self.ck[i].transpose(-1, -2))
            scores = scores.masked_fill(~self.src_keep, NEG_INF)
            ctx = torch.matmul(torch.softmax(scores, -1), self.cv[i])
            h = _ln(ln15, h + cp.o(_merge(ctx)), eps)
            h = _ln(blk.ln2, h + blk.ffn(h), eps)
            if valid is not None:
                h = h * valid
        return h[:, 0]


class _StopFlag:
    """The decode loops' stop test: whether every row had finished by the
    step before the last. Each step's flag is kept and the previous one
    read; on CUDA the flag is copied to pinned host memory behind an event,
    so the host waits for step t-1 while step t is queued (one event wait
    a step, ``waits``; the stream never drains)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.bufs = [torch.zeros((), dtype=torch.bool, pin_memory=True)
                         for _ in range(2)]
            self.events = [torch.cuda.Event(), torch.cuda.Event()]
        self.prev = None
        self.n = 0
        self.waits = 0

    def __call__(self, flag: torch.Tensor) -> bool:
        if not self.cuda:
            prev, self.prev = self.prev, flag
            return prev is not None and bool(prev)
        i = self.n % 2
        self.bufs[i].copy_(flag, non_blocking=True)
        self.events[i].record()
        self.n += 1
        if self.n == 1:
            return False
        self.events[1 - i].synchronize()
        self.waits += 1
        return bool(self.bufs[1 - i])


@torch.no_grad()
def generate_greedy(model, gen: M3PGen, src_enc: torch.Tensor,
                    src_len: torch.Tensor, *, max_len: int = 32,
                    stats: dict | None = None):
    """The reference's generate() with sample_temperature=None
    (:1211-1316): the <EOS>-seeded prefix, a single-position cached decode
    a step, argmax next token, PAD after a row finishes, the EOS backstop at
    max_len - 1 (gen_len not adjusted). No language embedding; the hidden
    state is zeroed where p >= gen_len.

    Returns (generated [max_len, B] int64, gen_len [B] int64); rows past
    gen_len are PAD (the reference returns generated[:cur_len]).
    ``stats``, when given, receives ``steps`` and ``host_waits``."""
    cfg = model.cfg
    pad = cfg.pad_token_id
    B = src_enc.shape[0]
    dev = src_enc.device
    dec = _Decoder(model, gen, src_enc, src_len, max_len)
    generated = torch.full((max_len, B), pad, dtype=torch.long, device=dev)
    generated[0] = EOS
    gen_len = torch.ones(B, dtype=torch.long, device=dev)
    unfinished = torch.ones(B, dtype=torch.long, device=dev)
    stop = _StopFlag(dev)
    steps = 0
    for cur in range(1, max_len):
        p = cur - 1
        valid = (p < gen_len).to(src_enc.dtype)[:, None, None]
        h = dec.step(generated[p], p, valid=valid)
        nxt = torch.argmax(pred_scores(model, gen, h), -1)
        generated[cur] = nxt * unfinished + pad * (1 - unfinished)
        gen_len += unfinished
        unfinished *= (generated[cur] != EOS).long()
        steps += 1
        if stop(unfinished.max() == 0):
            break
    # rows still unfinished at max_len end in <EOS>; a row that finished
    # earlier has unfinished 0, so this is the reference's backstop whether
    # or not the loop stopped early
    generated[max_len - 1] = torch.where(unfinished > 0, EOS,
                                         generated[max_len - 1])
    if stats is not None:
        stats.update(steps=steps, host_waits=stop.waits)
    return generated, gen_len


def _top_2k(scores: torch.Tensor, k2: int):
    """The 2K best of each row, sorted descending, the lower index first
    among equal values (``jax.lax.top_k``'s order): a stable descending
    sort."""
    vals, idxs = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[:, :k2], idxs[:, :k2]


@torch.no_grad()
def generate_beam(model, gen: M3PGen, src_enc: torch.Tensor,
                  src_len: torch.Tensor, *, beam_size: int,
                  length_penalty: float = 1.0, early_stopping: bool = False,
                  max_len: int = 32, lang_id: int = 0,
                  stats: dict | None = None):
    """The reference's generate_beam (:1317-1511, BeamHypotheses
    :1513-1556) at fixed shapes:

     - B * K rows, beam scores starting [0, -1e9, ...];
     - a step: the cached decode with ``cross_lang[lang_id]`` added, the
       log-softmax scores, the top 2K over each sentence's K * V lattice,
       then the candidate sweep in sorted order, one candidate at a time and
       every sentence at once: EOS candidates (every candidate at
       cur + 1 == max_len) go to the sentence's hypothesis store (capacity
       K, replace-worst behind a strictly-greater gate, the worst score
       tracked), the others fill the next beam until K are taken;
     - ``is_done`` (store full and worst >= best / (max_len - 1)^lp, or
       ``early_stopping``) on this step's best, before the sweep; done
       sentences emit (0, PAD, global row 0), so they gather sentence 0's
       caches;
     - a hypothesis scores sum-logprob / cur^lp, the prefix counting the
       <EOS> seed;
     - the end: the best slot of each store (slots start at -inf), plus one
       slot for the terminal <EOS>; a sentence without a hypothesis gives
       tgt_len 1.

    Returns (decoded [max_len, B] int64, tgt_len [B] int64); the reference
    returns decoded[:tgt_len.max()]. ``stats``, when given, receives
    ``steps``, ``host_waits`` and ``done_sentence_steps`` (the sentences
    that emitted PAD rows as done, summed over the steps)."""
    cfg = model.cfg
    pad, V = cfg.pad_token_id, cfg.vocab_size
    B = src_enc.shape[0]
    K = beam_size
    BK = B * K
    dev = src_enc.device
    lp = float(length_penalty)

    dec = _Decoder(model, gen, src_enc.repeat_interleave(K, 0),
                   src_len.repeat_interleave(K, 0), max_len)
    # the reorder buffers: each step gathers the self-attention cache into
    # the spare and swaps. The cross-attention K/V stay: a live sentence
    # picks beams of its own, whose rows of ck / cv are equal, and what a
    # done sentence (or the last step) decodes is never read.
    spare = {n: torch.empty_like(getattr(dec, n)) for n in ("kc", "vc")}
    lang_vec = gen.cross_lang[lang_id]
    norms = torch.arange(max_len, device=dev, dtype=torch.float32) ** lp
    generated = torch.full((max_len, BK), pad, dtype=torch.long, device=dev)
    generated[0] = EOS
    gen_spare = torch.empty_like(generated)
    beam_scores = torch.where(torch.arange(K, device=dev) == 0, 0.0, -1e9
                              ).repeat(B)
    ss = torch.full((B, K), NEG_INF, device=dev)               # store scores
    st = torch.full((B, K, max_len), pad, dtype=torch.long, device=dev)
    sl = torch.zeros((B, K), dtype=torch.long, device=dev)
    cnt = torch.zeros(B, dtype=torch.long, device=dev)
    wst = torch.full((B,), 1e9, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    rows = torch.arange(B, device=dev)
    slots = torch.arange(K, device=dev)
    stop = _StopFlag(dev)
    steps = 0
    done_steps = torch.zeros((), dtype=torch.long, device=dev)
    for cur in range(1, max_len):
        p = cur - 1
        h = dec.step(generated[p], p, lang_vec=lang_vec)
        scores = torch.log_softmax(pred_scores(model, gen, h).float(), -1)
        vals, idxs = _top_2k((scores + beam_scores[:, None]).reshape(B, K * V),
                             2 * K)
        full = cnt >= K
        done |= full & (early_stopping | (wst >= vals[:, 0] / norms[max_len - 1]))
        done_steps += done.sum()
        gen_cols = generated.t().reshape(B, K, max_len)

        # the candidate sweep (:1427-1460), every sentence at once
        n_sel = torch.zeros(B, dtype=torch.long, device=dev)
        sel_s = torch.zeros((B, K), device=dev)
        sel_w = torch.full((B, K), pad, dtype=torch.long, device=dev)
        sel_b = torch.zeros((B, K), dtype=torch.long, device=dev)
        for c in range(2 * K):
            value, idx = vals[:, c], idxs[:, c]
            beam_id, word = idx // V, idx % V
            active = ~done & (n_sel < K)
            is_add = (word == EOS) | (cur + 1 == max_len)
            score_norm = value / norms[cur]
            can_add = active & is_add & ((cnt < K) | (score_norm > wst))
            slot = torch.argmin(ss, 1)[:, None]
            ss2 = ss.scatter(1, slot, score_norm[:, None])
            st2 = st.clone()
            st2[rows, slot[:, 0]] = gen_cols[rows, beam_id]
            new_worst = torch.where(cnt < K, torch.minimum(score_norm, wst),
                                    ss2.min(1).values)
            ss = torch.where(can_add[:, None], ss2, ss)
            st = torch.where(can_add[:, None, None], st2, st)
            sl = torch.where(can_add[:, None], sl.scatter(1, slot, cur), sl)
            wst = torch.where(can_add, new_worst, wst)
            cnt = torch.where(can_add, torch.clamp(cnt + 1, max=K), cnt)
            at = (slots[None, :] == n_sel[:, None]) & (active & ~is_add)[:, None]
            sel_s = torch.where(at, value[:, None], sel_s)
            sel_w = torch.where(at, word[:, None], sel_w)
            sel_b = torch.where(at, beam_id[:, None], sel_b)
            n_sel = n_sel + (active & ~is_add).long()

        # done sentences and unfilled beams emit (0, PAD, global row 0)
        emit_pad = done[:, None] | (slots[None, :] >= n_sel[:, None])
        beam_scores = torch.where(emit_pad, 0.0, sel_s).reshape(-1)
        glob = torch.where(emit_pad, 0, rows[:, None] * K + sel_b).reshape(-1)
        torch.index_select(generated, 1, glob, out=gen_spare)
        generated, gen_spare = gen_spare, generated
        generated[cur] = torch.where(emit_pad, pad, sel_w).reshape(-1)
        for n, buf in spare.items():
            torch.index_select(getattr(dec, n), 1, glob, out=buf)
            spare[n] = getattr(dec, n)
            setattr(dec, n, buf)
        steps += 1
        if stop(done.all()):
            break

    best = torch.argmax(ss, 1)
    best_tokens = st[rows, best]                                  # [B, max_len]
    best_len = sl[rows, best]
    ar = torch.arange(max_len, device=dev)[None, :]
    decoded = torch.where(ar < best_len[:, None], best_tokens, pad)
    decoded = torch.where(ar == best_len[:, None], EOS, decoded)
    if stats is not None:
        stats.update(steps=steps, host_waits=stop.waits,
                     done_sentence_steps=int(done_steps))
    return decoded.t().contiguous(), best_len + 1
