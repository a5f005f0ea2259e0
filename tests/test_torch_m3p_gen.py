"""The port's M3P generation modes (clg_vqa_tpu_torch/models/m3p_gen.py and
the gen half of utils/convert.py) against the JAX package's m3p_gen on the
same weights at a small config (2 layers, H 64, 4 heads, V 300, a refiner
of 2), and against the reference's golden outputs
(tests/fixtures/m3p_gen_golden.npz).

Tolerances: every function within rtol 2e-4, atol 2e-5
(tests/test_m3p_gen_parity.py's); greedy and beam decoding token for token
and length for length."""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clg_vqa_tpu.config import M3PConfig as JConfig
from clg_vqa_tpu.models import m3p_gen as jg
from clg_vqa_tpu.utils import convert as JC
from clg_vqa_tpu_torch.config import M3PConfig
from clg_vqa_tpu_torch.models import m3p_gen as tg
from clg_vqa_tpu_torch.models.m3p_gen import M3PGen
from clg_vqa_tpu_torch.utils import convert as TC

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
SMALL = dict(vocab_size=300, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=256, v_feature_size=32, num_locs=5,
             pooler_size=64, clf_hidden_size=128, num_labels=10)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "m3p_gen_golden.npz")
MAX_LEN = 12


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(torch.as_tensor(got).numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _params(seed: int, eos_boost: float = 0.0, lively: bool = False):
    """JAX init_gen_params with every leaf moved by N(0, 0.02) noise (the
    init's biases are zero and its LN scales one, which would leave those
    paths untested), and ``eos_boost`` added to pred_bias[EOS]. A random
    decoder mostly repeats its input token; ``lively`` scales the position
    table by 20 and the cross-attention's v and o by 3 and 30, so that the
    hidden state moves with the position and the source and rows finish at
    different steps."""
    p = jg.init_gen_params(jax.random.key(seed), JConfig(**SMALL),
                           refine_layers=2)
    r = np.random.RandomState(seed)
    p = jax.tree.map(lambda a: (np.asarray(a, np.float32) + 0.02 * r.randn(
        *np.shape(a))).astype(np.float32), p)
    p["gen"]["pred_bias"][2] += eos_boost
    if lively:
        p["embeddings"]["position"] *= 20
        p["gen"]["encoder_attn"]["v"]["w"] *= 3
        p["gen"]["encoder_attn"]["o"]["w"] *= 30
    return p


@pytest.fixture(scope="module", params=[0, 1])
def world(request):
    seed = request.param
    params = _params(seed)
    model, gen = TC.from_jax_gen_params(params, M3PConfig(**SMALL), device="cpu")
    r = np.random.RandomState(100 + seed)
    return SimpleNamespace(seed=seed, jp=params, jcfg=JConfig(**SMALL),
                           model=model, gen=gen, r=r)


def _src(r, B=3, S=7, H=64, lens=(7, 3, 5)):
    return r.randn(B, S, H).astype(np.float32), np.asarray(lens[:B], np.int32)


def test_from_jax_gen_params_carries_gen(world):
    """Every leaf of ``params["gen"]`` lands in the gen module (stacked
    encoder_attn / ln15 split per block, the refiner tuple by index), the
    rest in the M3P; the MLM projection is the M3P's word table."""
    g = world.jp["gen"]
    gen = world.gen
    assert len(gen.refiner.layers) == 2 and len(gen.encoder_attn) == 2
    for i in range(2):
        np.testing.assert_array_equal(
            gen.encoder_attn[i].k.weight.detach().numpy(),
            g["encoder_attn"]["k"]["w"][i].T)
        np.testing.assert_array_equal(gen.ln15[i].weight.detach().numpy(),
                                      g["ln15"]["scale"][i])
    np.testing.assert_array_equal(
        gen.refiner.layers[1].aoa.weight.detach().numpy(),
        g["refiner"]["layers"][1]["aoa"]["w"].T)
    np.testing.assert_array_equal(gen.pred_bias.detach().numpy(), g["pred_bias"])
    np.testing.assert_array_equal(world.model.embeddings.word.detach().numpy(),
                                  world.jp["embeddings"]["word"])
    assert not any("word" in k for k in gen.state_dict())
    with pytest.raises(KeyError):          # from_jax_params takes no gen
        TC.from_jax_params(world.jp, M3PConfig(**SMALL), device="cpu")


@pytest.mark.parametrize("causal,with_src,lang", [
    (False, False, None), (True, False, None), (True, True, None),
    (True, True, 1), (False, True, 0)])
def test_crossfwd(world, causal, with_src, lang):
    r = world.r
    x = r.randint(0, 300, (3, 9)).astype(np.int32)
    lengths = np.asarray([9, 4, 6], np.int32)
    src, src_len = _src(r)
    pos = np.stack([np.arange(9)] * 3).astype(np.int32) + 2
    kw = dict(causal=causal, lang_id=lang)
    if with_src:
        kw.update(src_enc=src, src_len=src_len)
    want = jg.crossfwd(world.jp, world.jcfg, jnp.asarray(x), jnp.asarray(lengths),
                       positions=jnp.asarray(pos),
                       **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                          for k, v in kw.items()})
    with torch.no_grad():
        got = tg.crossfwd(world.model, world.gen, torch.from_numpy(x),
                          torch.from_numpy(lengths), positions=torch.from_numpy(pos),
                          **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                                 else v) for k, v in kw.items()})
    _close(got, want)


def test_get_masks_match():
    lengths = np.asarray([5, 2, 7], np.int32)
    for causal in (False, True):
        jm, ja = jg.get_masks(7, jnp.asarray(lengths), causal)
        tm, ta = tg.get_masks(7, torch.from_numpy(lengths), causal)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_image_embed_refined_and_aoa(world):
    r = world.r
    feats = r.randn(3, 6, 32).astype(np.float32)
    locs = r.rand(3, 6, 5).astype(np.float32)
    lens = np.asarray([6, 2, 4], np.int32)
    want, wmask = jg.image_embed_refined(world.jp, world.jcfg, jnp.asarray(feats),
                                         jnp.asarray(locs), jnp.asarray(lens))
    with torch.no_grad():
        got, gmask = tg.image_embed_refined(
            world.model, world.gen, torch.from_numpy(feats),
            torch.from_numpy(locs), torch.from_numpy(lens))
        x = r.randn(3, 6, 64).astype(np.float32)
        a = tg.aoa_refine(world.gen, torch.from_numpy(x), gmask)
    _close(got, want)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    _close(a, jg.aoa_refine(world.jp["gen"], world.jcfg, jnp.asarray(x), wmask))


@pytest.mark.parametrize("head", ["relation", "clcm", "mrfr", "obj", "mlm"])
def test_predict_heads(world, head):
    t = world.r.randn(3, 9, 64).astype(np.float32)
    want = jg.predict(world.jp, world.jcfg, jnp.asarray(t), head=head)
    with torch.no_grad():
        got = tg.predict(world.model, world.gen, torch.from_numpy(t), head=head)
    _close(got, want, atol=3e-5 if head == "obj" else ATOL)


def test_pred_scores_and_mlm_loss(world):
    r = world.r
    h = r.randn(4, 9, 64).astype(np.float32)
    y = r.randint(0, 300, (4, 9)).astype(np.int32)
    pm = r.rand(4, 9) < 0.3
    js = jg.pred_scores(world.jp, jnp.asarray(h))
    with torch.no_grad():
        ts = tg.pred_scores(world.model, world.gen, torch.from_numpy(h))
        loss = tg.mlm_loss(ts, torch.from_numpy(y), torch.from_numpy(pm))
    _close(ts, js)
    want = jg.mlm_loss(js, jnp.asarray(y), jnp.asarray(pm))
    np.testing.assert_allclose(float(loss), float(want), rtol=2e-5)
    with torch.no_grad():
        empty = tg.mlm_loss(ts, torch.from_numpy(y), torch.zeros(4, 9, dtype=torch.bool))
    assert float(empty) == 0.0


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 64)])
def test_vae_encode_and_latent_decode(world, shape):
    r = world.r
    x = r.randn(*shape).astype(np.float32)
    c = r.randn(*shape).astype(np.float32)
    g = world.gen
    want, kld = jg.vae_encode(world.jp["gen"], jnp.asarray(x), jnp.asarray(c))
    assert kld is None
    with torch.no_grad():
        got, tkld = tg.vae_encode(g, torch.from_numpy(x), torch.from_numpy(c))
    assert tkld is None
    _close(got, want)
    # the sampling path: JAX's own noise, fed to the port as ``eps``
    key = jax.random.key(7)
    want, wkld = jg.vae_encode(world.jp["gen"], jnp.asarray(x), jnp.asarray(c),
                               rng=key)
    eps = np.array(jax.random.normal(key, shape, jnp.float32))
    with torch.no_grad():
        got, gkld = tg.vae_encode(g, torch.from_numpy(x), torch.from_numpy(c),
                                  eps=torch.from_numpy(eps))
    _close(got, want)
    _close(gkld, wkld)
    with torch.no_grad():
        a = tg.vae_encode(g, torch.from_numpy(x), torch.from_numpy(c),
                          generator=torch.Generator().manual_seed(3))
        b = tg.vae_encode(g, torch.from_numpy(x), torch.from_numpy(c),
                          generator=torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    h = r.randn(3, 9, 64).astype(np.float32)
    with torch.no_grad():
        got = tg.latent_decode(g, torch.from_numpy(h))
    _close(got, jg.latent_decode(world.jp["gen"], jnp.asarray(h)))


def _greedy_both(jp, model, gen, src, src_len, max_len=MAX_LEN, **kw):
    wg, wl = jg.generate_greedy(jp, JConfig(**SMALL), jnp.asarray(src),
                                jnp.asarray(src_len), max_len=max_len)
    tgen, tl = tg.generate_greedy(model, gen, torch.from_numpy(src),
                                  torch.from_numpy(src_len.astype(np.int64)),
                                  max_len=max_len, **kw)
    return (np.asarray(wg), np.asarray(wl)), (tgen.numpy(), tl.numpy())


# (seed, eos_boost, lively, what the lengths show): "backstop" every row
# runs to max_len and ends in the EOS backstop; "mixed" rows finish at
# different steps, one of them after the first and before max_len (PAD
# after a finished row, gen_len counting only unfinished rows; case 3 also
# has rows that reach max_len); "first" every row finishes
# at the first step and the loop stops early
GREEDY_CASES = [(0, 0.0, False, None), (4, 0.0, True, "backstop"),
                (2, 0.5, True, "mixed"), (3, 0.5, True, "mixed"),
                (6, 1.0, True, "mixed"), (1, 40.0, False, "first")]


@pytest.mark.parametrize("seed,eos_boost,lively,shows", GREEDY_CASES)
def test_generate_greedy_token_exact(seed, eos_boost, lively, shows):
    jp = _params(seed, eos_boost, lively)
    model, gen = TC.from_jax_gen_params(jp, M3PConfig(**SMALL), device="cpu")
    r = np.random.RandomState(seed)
    src, src_len = _src(r, B=4, lens=(7, 3, 5, 1))
    (wg, wl), (tgn, tl) = _greedy_both(jp, model, gen, src, src_len)
    np.testing.assert_array_equal(tgn, wg)
    np.testing.assert_array_equal(tl, wl)
    if shows == "backstop":
        assert (wl == MAX_LEN).all() and (wg[-1] == 2).all(), wl
    if shows == "mixed":
        assert len(set(wl.tolist())) > 1 and ((wl > 2) & (wl < MAX_LEN)).any(), wl
    if shows == "first":
        assert (wl == 2).all(), wl


BEAM_CASES = [
    # (seed, beam, length_penalty, early_stopping, lang_id, eos_boost, lively)
    (0, 1, 1.0, False, 0, 0.0, False),
    (1, 3, 1.0, False, 0, 0.0, True),
    (2, 3, 0.6, True, 1, 0.0, True),
    (3, 4, 2.0, False, 1, 0.0, True),
    (2, 3, 1.0, False, 0, 0.5, True),
    (3, 3, 1.0, False, 0, 0.5, True),
    (5, 4, 0.6, False, 1, 1.0, True),
    (6, 3, 2.0, True, 0, 1.0, True),
    (7, 1, 1.0, True, 1, 1.0, True),
    (3, 3, 0.6, False, 1, 1.0, True),
]


@pytest.mark.parametrize("seed,beam,lp,es,lang,eos_boost,lively", BEAM_CASES)
def test_generate_beam_token_exact(seed, beam, lp, es, lang, eos_boost, lively):
    jp = _params(seed, eos_boost, lively)
    model, gen = TC.from_jax_gen_params(jp, M3PConfig(**SMALL), device="cpu")
    r = np.random.RandomState(50 + seed)
    src, src_len = _src(r, B=3, lens=(7, 2, 5))
    kw = dict(beam_size=beam, length_penalty=lp, early_stopping=es,
              max_len=MAX_LEN, lang_id=lang)
    wd, wl = jg.generate_beam(jp, JConfig(**SMALL), jnp.asarray(src),
                              jnp.asarray(src_len), **kw)
    stats = {}
    td, tl = tg.generate_beam(model, gen, torch.from_numpy(src),
                              torch.from_numpy(src_len.astype(np.int64)),
                              stats=stats, **kw)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(td.numpy(), np.asarray(wd))
    if eos_boost:
        # sentences finished while the loop ran on: their rows emitted
        # (0, PAD, global row 0) and gathered sentence 0's caches
        assert stats["done_sentence_steps"] > 0, stats


def test_decoders_stop_one_step_after_every_row_finished():
    """The loops read the all-finished flag one step late, so they run one
    step past JAX's stop; the outputs stay JAX's (every row here finishes
    at the first step)."""
    jp = _params(1, 40.0)
    model, gen = TC.from_jax_gen_params(jp, M3PConfig(**SMALL), device="cpu")
    src, src_len = _src(np.random.RandomState(1), B=3, lens=(7, 2, 5))
    (wg, wl), (tgn, tl) = _greedy_both(jp, model, gen, src, src_len)
    np.testing.assert_array_equal(tgn, wg)
    np.testing.assert_array_equal(tl, wl)
    stats = {}
    tg.generate_greedy(model, gen, torch.from_numpy(src),
                       torch.from_numpy(src_len.astype(np.int64)),
                       max_len=MAX_LEN, stats=stats)
    assert (wl == 2).all() and stats["steps"] == 2
    kw = dict(beam_size=3, length_penalty=1.0, early_stopping=True,
              max_len=MAX_LEN, lang_id=0)
    wd, wbl = jg.generate_beam(jp, JConfig(**SMALL), jnp.asarray(src),
                               jnp.asarray(src_len), **kw)
    td, tbl = tg.generate_beam(model, gen, torch.from_numpy(src),
                               torch.from_numpy(src_len.astype(np.int64)),
                               stats=stats, **kw)
    np.testing.assert_array_equal(td.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(tbl.numpy(), np.asarray(wbl))
    assert stats["steps"] < MAX_LEN - 1 and stats["host_waits"] == 0


def test_generation_refuses_a_vocabulary_shard(world):
    src, src_len = _src(world.r)
    model = world.model
    model.embeddings.mesh = SimpleNamespace(n_mp=2)
    try:
        for fn in (tg.generate_greedy, tg.generate_beam):
            kw = {"beam_size": 2} if fn is tg.generate_beam else {}
            with pytest.raises(ValueError, match="vocabulary shard"):
                fn(model, world.gen, torch.from_numpy(src),
                   torch.from_numpy(src_len), max_len=4, **kw)
    finally:
        model.embeddings.mesh = None


def test_init_weights_is_seeded():
    cfg = M3PConfig(**SMALL)
    a = M3PGen(cfg, refine_layers=2, device="cpu", seed=3)
    b = M3PGen(cfg, refine_layers=2, device="cpu", seed=3)
    assert all(torch.equal(a.state_dict()[k], v) for k, v in b.state_dict().items())
    assert float(a.pred_bias.detach().abs().sum()) == 0.0
    assert float(a.refiner.norm.weight.detach().mean()) == 1.0
    assert abs(float(a.mrfr.weight.detach().std()) - 0.02) < 2e-3


# ---------------------------------------------------------------------------
# The reference's golden outputs, through the port's converters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    g = np.load(FIXTURE, allow_pickle=False)
    nL, rl = int(g["n_layers"]), int(g["refine_layers"])
    sd = {k[len("sd::"):]: np.asarray(g[k]) for k in g.files if k.startswith("sd::")}
    H = sd["embeddings.weight"].shape[1]
    cfg = M3PConfig(vocab_size=sd["embeddings.weight"].shape[0], hidden_size=H,
                    num_layers=nL, num_heads=4, intermediate_size=4 * H,
                    num_locs=5, pooler_size=H, clf_hidden_size=2 * H,
                    pad_token_id=1)
    model = TC.load_numpy_state(
        TC.M3P(cfg, device="cpu"),
        TC.volta_m3p_to_state_dict({"bert.encoder." + k: v for k, v in sd.items()},
                                   cfg), allow_missing=("classifier.",))
    gen = TC.load_numpy_state(
        M3PGen(cfg, refine_layers=rl, device="cpu"),
        TC.m3p_gen_components_to_state_dict(sd, cfg, refine_layers=rl))
    return g, cfg, sd, model, gen


def test_gen_converter_matches_jax(golden):
    """m3p_gen_components_to_state_dict gives the tensors of JAX's
    m3p_gen_components_to_pytree, by the port's names."""
    g, cfg, sd, model, gen = golden
    jtree = JC.m3p_gen_components_to_pytree(sd, JConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_layers=cfg.num_layers, num_heads=4,
        intermediate_size=cfg.intermediate_size),
        refine_layers=int(g["refine_layers"]))
    want = TC.jax_params_to_state_dict(jax.tree.map(np.asarray, jtree))
    got = {k: v.numpy() for k, v in gen.state_dict().items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_golden_crossfwd_heads_and_vae(golden):
    g, cfg, sd, model, gen = golden
    x = torch.from_numpy(g["x"]).long()
    lengths = torch.from_numpy(g["lengths"]).long()
    src, src_len = torch.from_numpy(g["src_enc"]), torch.from_numpy(g["src_len"])
    with torch.no_grad():
        _close(tg.crossfwd(model, gen, x, lengths, causal=False), g["t_plain"])
        _close(tg.crossfwd(model, gen, x, lengths, causal=True, src_enc=src,
                           src_len=src_len), g["t_causal"])
        t, _ = tg.image_embed_refined(
            model, gen, torch.from_numpy(g["feats"]).transpose(0, 1),
            torch.from_numpy(g["locs"]).transpose(0, 1),
            torch.from_numpy(g["img_len"]))
        _close(t, g["img_refined"])
        t = torch.from_numpy(g["t_causal"])
        for head, key, atol in (("relation", "rel", ATOL), ("clcm", "clcm", ATOL),
                                ("mrfr", "mrfr", ATOL), ("obj", "obj_scores", 3e-5)):
            _close(tg.predict(model, gen, t, head=head), g[key], atol=atol)
        scores = tg.predict(model, gen, t, head="mlm")
        pm = np.asarray(g["pred_mask"], bool)
        _close(scores.numpy().transpose(1, 0, 2)[pm], g["mlm_scores"])
        y = np.zeros(pm.shape, np.int64)
        y[pm] = g["mlm_y"]
        loss = tg.mlm_loss(scores.transpose(0, 1), torch.from_numpy(y),
                           torch.from_numpy(pm))
        np.testing.assert_allclose(float(loss), float(g["mlm_loss"]), rtol=2e-5)
        out, kld = tg.vae_encode(gen, torch.from_numpy(g["vae_x"]),
                                 torch.from_numpy(g["vae_c"]))
        assert kld is None
        _close(out, g["vae_out"])
        _close(tg.latent_decode(gen, torch.from_numpy(g["ld_in"])), g["ld_out"])


def test_golden_greedy_and_beam_token_exact(golden):
    g, cfg, sd, model, gen = golden
    src, src_len = torch.from_numpy(g["src_enc"]), torch.from_numpy(g["src_len"])
    out, gen_len = tg.generate_greedy(model, gen, src, src_len, max_len=12)
    ref = np.asarray(g["gen"])
    np.testing.assert_array_equal(out.numpy()[:ref.shape[0]], ref)
    np.testing.assert_array_equal(gen_len.numpy(), g["gen_len"])
    assert (out.numpy()[ref.shape[0]:] == cfg.pad_token_id).all()
    dec, tgt_len = tg.generate_beam(model, gen, src, src_len, beam_size=3,
                                    length_penalty=1.0, early_stopping=False,
                                    max_len=12, lang_id=0)
    ref = np.asarray(g["beam"])
    np.testing.assert_array_equal(tgt_len.numpy(), g["beam_len"])
    np.testing.assert_array_equal(dec.numpy()[:ref.shape[0]], ref)
    assert (dec.numpy()[ref.shape[0]:] == cfg.pad_token_id).all()
