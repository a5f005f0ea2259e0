"""The port's multi-process layer (clg_vqa_tpu_torch/parallel/, the Megatron
layers of models/layers.py, train/loop.shard_train_step,
eval/runner.shard_predict_step) against the JAX package, on the CPU.

Real worlds: this file run as ``python tests/test_torch_parallel.py worker
...`` is one rank; the module-scoped fixtures spawn a dp 2 x mp 2 world (4
processes) and a dp 2 world (2 processes) over gloo, each rank running every
case once and writing its results to an npz, so the file costs seconds. The
workers import no JAX; the fixtures compute the JAX side meanwhile (the
single-device step and its shard_train_step on a virtual dp 2 x mp 2 mesh).

Tolerances, those of tests/test_train.py:196-200: parameters after two steps
rtol 2e-4 / atol 1e-5, loss rtol 1e-5, grad_norm rtol 1e-5; predictions
bit-equal (tests/test_data_eval.py:236-275); the two-process pipeline world
bit-equal across ranks and within rtol 1e-6 of one process
(tests/test_distributed.py:80-123); the bf16 Megatron linears bit-equal to
one cast of the all-reduced fp32 sums and within one bf16 ulp of one
device."""
import fcntl
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

from clg_vqa_tpu_torch.config import M3PConfig, UC2Config  # noqa: E402
from clg_vqa_tpu_torch.data.pipeline import TrainPipeline  # noqa: E402
from clg_vqa_tpu_torch.eval import runner as trun  # noqa: E402
from clg_vqa_tpu_torch.models import layers as TL  # noqa: E402
from clg_vqa_tpu_torch.models.uc2 import UC2  # noqa: E402
from clg_vqa_tpu_torch.ops import attention as TA  # noqa: E402
from clg_vqa_tpu_torch.parallel import distributed as tdist  # noqa: E402
from clg_vqa_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from clg_vqa_tpu_torch.train import loop as tloop  # noqa: E402
from clg_vqa_tpu_torch.train import optim as topt  # noqa: E402
from clg_vqa_tpu_torch.utils import convert as TC  # noqa: E402

torch.set_num_threads(1)

SPAWN_TIMEOUT = 300          # seconds a world may take before it is killed
UC2_TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64, v_feature_size=16, num_locs=7,
                pooler_size=32, clf_hidden_size=32, num_labels=8)
M3P_TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64, v_feature_size=16, num_locs=5,
                pooler_size=32, clf_hidden_size=64, num_labels=8, max_boxes=4)
UC2_OFF = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               clf_dropout_prob=0.0)
M3P_OFF = dict(dropout=0.0, attention_dropout=0.0, clf_dropout_prob=0.0)
# case -> (model, config, fused_attn, step seed, grad mask): two fp32 steps
# of acc 2 x mbs 8 without dropout ("flat" takes B1 with a seed at rate 0);
# uc2_uneven has a vocabulary (61) and labels (7) that mp 2 does not divide
TRAIN_CASES = {
    "uc2_plain": ("uc2", UC2_TINY, False, None, False),
    "uc2_flat": ("uc2", UC2_TINY, "flat", 0, False),
    "uc2_uneven": ("uc2", dict(UC2_TINY, vocab_size=61, num_labels=7),
                   "flat", 0, False),
    "m3p_plain": ("m3p", M3P_TINY, False, None, False),
    "uc2_mask": ("uc2", UC2_TINY, False, None, True),
}
# JAX's sharded step refuses these at its jit boundary (an input sharding
# must divide its dimension), so they are held to its single-device step
UNEVEN = ("uc2_uneven",)
DROPOUT_ROUTES = (False, "flat")
ACC, MBS, T, R = 2, 8, 6, 4
N_DP, N_MP = 2, 2


def _port_config(kind, over):
    return (UC2Config(**over, **UC2_OFF) if kind == "uc2"
            else M3PConfig(**over, **M3P_OFF))


def _batch(seed, cfg, lead):
    r = np.random.RandomState(seed)
    return {"input_ids": r.randint(3, cfg.vocab_size, lead + (T,)).astype(np.int32),
            "input_mask": np.ones(lead + (T,), np.int32),
            "features": r.randn(*lead, R, cfg.v_feature_size).astype(np.float32),
            "locs": r.rand(*lead, R, cfg.num_locs).astype(np.float32),
            "image_mask": np.ones(lead + (R,), np.int32),
            "labels": r.randint(0, cfg.num_labels, lead).astype(np.int32)}


def _linear_inputs():
    r = np.random.RandomState(9)
    return {"x": r.randn(10, 24).astype(np.float32),
            "w": (r.randn(16, 24) * 0.3).astype(np.float32),
            "b": r.randn(16).astype(np.float32),
            "g": r.randn(10, 16).astype(np.float32)}


# ---------------------------------------------------------------------------
# the worker: one rank of a spawned world (no JAX here)
# ---------------------------------------------------------------------------

def _tensors(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _sub(npz, prefix):
    return {k[len(prefix):]: npz[k] for k in npz.files if k.startswith(prefix)}


def _train_case(name, inp, mesh, out):
    kind, over, fused, seed, masked = TRAIN_CASES[name]
    cfg = _port_config(kind, over)
    model = TC.load_numpy_state(TC.model_class(cfg)(cfg, device="cpu"),
                                _sub(inp, f"{name}/sd/"))
    tmesh.shard_model(model, mesh)
    b0 = _tensors(_sub(inp, f"{name}/b0/"))
    pred_step = trun.shard_predict_step(
        model, mesh, compute_dtype=None, fused_attn=fused)
    out[f"{name}/pred"] = pred_step({k: v[0] for k, v in b0.items()}).numpy()
    opt = topt.make_optimizer([n for n, _ in model.named_parameters()], 1e-3,
                              weight_decay=1e-4, clip_norm=1.0)
    mask = None
    if masked:      # whole tensors or None: the sharded step slices them
        mask = dict.fromkeys(model.state_dict())
        mask.update(_tensors(_sub(inp, f"{name}/mask/")))
    step = tloop.shard_train_step(tloop.make_train_step(
        opt, torch.from_numpy(inp[f"{name}/D"]), semantic_lambda=10.0,
        top_k=4, compute_dtype=None, fused_attn=fused, grad_mask=mask), mesh)
    state = tloop.TrainState(model, opt.init(dict(model.named_parameters())), 0)
    for i in range(2):
        b = tmesh.local_batch(_tensors(_sub(inp, f"{name}/b{i}/")), mesh,
                              microbatched=True)
        state, m = step(state, b, seed)
        out[f"{name}/metrics{i}"] = np.array(
            [m["loss"].item(), m["grad_norm"].item(), m["score"].item()])
    for k, v in tmesh.unshard_state_dict(model, mesh).items():
        out[f"{name}/final/{k}"] = v.numpy()


def _dropout_case(fused, inp, mesh, out, run):
    """One sharded step of the tiny UC2 with dropout 0.1, recording every
    mask it realizes: the hidden sites' (layers.dropout on activations) and
    the attention's (layers.dropout on probabilities, or B1's
    dropout_keep_mask)."""
    hidden, attention = [], []
    dropout, keep_mask = TL.dropout, TA.dropout_keep_mask

    def rec_dropout(x, rate, gen):
        if gen is not None:     # the bits this call draws, on ones
            again = torch.Generator().set_state(gen.get_state())
            keep = dropout(torch.ones(x.shape), rate, again) != 0
            (attention if x.dim() == 4 else hidden).append(keep.numpy())
        return dropout(x, rate, gen)

    def rec_keep_mask(*args, **kw):
        m = keep_mask(*args, **kw)
        attention.append(m.numpy())
        return m

    TL.dropout, TA.dropout_keep_mask = rec_dropout, rec_keep_mask
    try:
        cfg = UC2Config(**UC2_TINY)
        model = TC.load_numpy_state(UC2(cfg, device="cpu"),
                                    _sub(inp, "uc2_plain/sd/"))
        tmesh.shard_model(model, mesh)
        opt = topt.make_optimizer([n for n, _ in model.named_parameters()], 1e-3)
        step = tloop.shard_train_step(tloop.make_train_step(
            opt, torch.from_numpy(inp["uc2_plain/D"]), semantic_lambda=10.0,
            top_k=4, compute_dtype=None, fused_attn=fused), mesh)
        state = tloop.TrainState(model, opt.init(dict(model.named_parameters())), 0)
        b = tmesh.local_batch(_tensors(_sub(inp, "uc2_plain/b0/")), mesh,
                              microbatched=True)
        step(state, b, 7)
    finally:
        TL.dropout, TA.dropout_keep_mask = dropout, keep_mask
    key = f"dropout_{fused}/run{run}"
    for i, m in enumerate(hidden):
        out[f"{key}/hidden{i}"] = m
    for i, m in enumerate(attention):
        out[f"{key}/attention{i}"] = m
    out[f"{key}/params"] = np.concatenate(
        [p.detach().reshape(-1).numpy() for p in model.parameters()])


def _state_case(inp, mesh, out):
    """A whole TrainState with nonzero moments through
    loop.shard_train_state, and back through mesh.unshard."""
    cfg = _port_config("uc2", dict(UC2_TINY, vocab_size=61, num_labels=7))
    model = TC.load_numpy_state(UC2(cfg, device="cpu"),
                                _sub(inp, "uc2_uneven/sd/"))
    opt = topt.make_optimizer([n for n, _ in model.named_parameters()], 1e-3)
    state = tloop.TrainState(model, opt.init(dict(model.named_parameters())), 3)
    g = torch.Generator().manual_seed(5)
    for t in (*state.opt_state.mu.values(), *state.opt_state.nu.values()):
        t.copy_(torch.randn(t.shape, generator=g))
    whole = {k: v.clone() for k, v in state.opt_state.mu.items()}
    state = tloop.shard_train_state(state, mesh)
    local = tmesh.shard_state_dict(whole, mesh)
    assert all(torch.equal(local[k], v) for k, v in state.opt_state.mu.items())
    assert all(state.opt_state.mu[k].shape == p.shape
               for k, p in model.named_parameters())
    for k, v in tmesh.unshard(state.opt_state.mu, mesh).items():
        out[f"state/mu/{k}"] = v.numpy()
        out[f"state/whole/{k}"] = whole[k].numpy()
    assert state.step == 3 and model.mesh is mesh


def _linear_case(inp, mesh, out):
    """The bf16 Megatron pair at mp 2: a row-parallel forward and a
    column-parallel backward on this rank's slices."""
    x, w, b, g = (torch.from_numpy(inp[f"linear/{k}"]) for k in "xwbg")
    lo, hi = mesh.shard_range(w.shape[1])
    y = TL.linear(x[:, lo:hi], w[:, lo:hi], b, torch.bfloat16,
                  group=mesh.mp_group, row=True)
    out["linear/row_y"] = y.float().numpy()
    lo, hi = mesh.shard_range(w.shape[0])
    xx = x.clone().requires_grad_()
    y = TL.linear(xx, w[lo:hi], b[lo:hi], torch.bfloat16, group=mesh.mp_group)
    y.backward(g[:, lo:hi].bfloat16())
    out["linear/col_dx"] = xx.grad.numpy()


def _pipeline_case(mesh, out):
    """dp 2 over TrainPipeline(host_id, num_hosts=2) (the port of
    tests/distributed_worker.py): each rank trains one step on its own
    host's rows."""
    from distributed_worker import SynthDataset
    cfg = UC2Config(**UC2_TINY, **UC2_OFF)
    pipe = TrainPipeline(SynthDataset(64, cfg), micro_batch_size=MBS // 2,
                         grad_acc_steps=ACC, seed=3, host_id=tdist.host_id(),
                         num_hosts=tdist.num_hosts(), device_put=False)
    it = pipe.epoch(0)
    host = next(it)
    it.close()
    model, step, state = _pipeline_world(cfg, mesh)
    state, m = step(state, _tensors(host), None)
    out["loss"] = m["loss"].item()
    out["params"] = np.concatenate(
        [p.detach().reshape(-1).numpy() for p in model.parameters()])


def _pipeline_world(cfg, mesh=None):
    model = UC2(cfg, device="cpu", seed=0)
    if mesh is not None:
        tmesh.shard_model(model, mesh)
    opt = topt.make_optimizer([n for n, _ in model.named_parameters()], 1e-3,
                              weight_decay=1e-4, clip_norm=1.0)
    D = torch.from_numpy(np.random.RandomState(0).rand(
        cfg.num_labels, cfg.num_labels).astype(np.float32))
    step = tloop.make_train_step(opt, D, semantic_lambda=10.0, top_k=4,
                                 compute_dtype=None)
    if mesh is not None:
        step = tloop.shard_train_step(step, mesh)
    return model, step, tloop.TrainState(
        model, opt.init(dict(model.named_parameters())), 0)


def worker(world_dir: str, rank: int, size: int, what: str) -> None:
    dev = tdist.initialize(f"file://{world_dir}/rendezvous", size, rank,
                           device="cpu")
    assert dev.type == "cpu" and tdist.host_id() == rank
    assert tdist.num_hosts() == size and tdist.is_primary() == (rank == 0)
    out = {}
    if what == "pipeline":
        _pipeline_case(tmesh.make_mesh(n_dp=size), out)
    else:
        inp = np.load(os.path.join(world_dir, "inputs.npz"))
        try:
            tmesh.make_mesh(n_dp=3, n_mp=2)
        except ValueError as e:
            out["mesh_error"] = str(e)
        mesh = tmesh.make_mesh(n_dp=N_DP, n_mp=N_MP)
        out["ranks"] = np.array([mesh.dp_rank, mesh.mp_rank])
        for name in TRAIN_CASES:
            _train_case(name, inp, mesh, out)
        for fused in DROPOUT_ROUTES:
            for run in range(2):
                _dropout_case(fused, inp, mesh, out, run)
        _linear_case(inp, mesh, out)
        _state_case(inp, mesh, out)
    np.savez(os.path.join(world_dir, f"out{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


def _spawn(world_dir: Path, size: int, what: str) -> list:
    """Run a world of ``size`` ranks of this file; returns their npz
    results. Ranks still running SPAWN_TIMEOUT seconds after the start are
    killed, and a failed world reports every rank's output."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    env.pop("XLA_FLAGS", None)
    logs = [open(world_dir / f"log{r}.txt", "w") for r in range(size)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "worker", str(world_dir), str(r), str(size),
         what], stdout=logs[r], stderr=subprocess.STDOUT, env=env,
        cwd=str(ROOT / "tests")) for r in range(size)]
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p, f in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    text = "\n".join(f"--- rank {r} (exit {p.returncode}) ---\n"
                     + (world_dir / f"log{r}.txt").read_text()[-3000:]
                     for r, p in enumerate(procs))
    assert all(p.returncode == 0 for p in procs), text
    return [dict(np.load(world_dir / f"out{r}.npz")) for r in range(size)]


# ---------------------------------------------------------------------------
# the JAX side and the fixtures
# ---------------------------------------------------------------------------

MASKED = ("embeddings/word", "attn/q/w", "attn/o/w", "ffn/w2/w",
          "classifier/fc2", "pooler/w")


def _jax_inputs(name):
    """(JAX config, forward, params, D, [batch0, batch1], grad mask tree or
    None) of a train case, from seeds."""
    import jax
    from clg_vqa_tpu.config import M3PConfig as JM, UC2Config as JU
    from clg_vqa_tpu.models import m3p as jm3p, uc2 as juc2
    kind, over, _, _, masked = TRAIN_CASES[name]
    cfg = JU(**over, **UC2_OFF) if kind == "uc2" else JM(**over, **M3P_OFF)
    mod = juc2 if kind == "uc2" else jm3p
    params = jax.tree.map(np.asarray, mod.init_params(jax.random.key(1), cfg))
    r = np.random.RandomState(1)
    D = r.rand(cfg.num_labels, cfg.num_labels).astype(np.float32)
    batches = [_batch(10 + i, cfg, (ACC, MBS)) for i in range(2)]
    mask = None
    if masked:
        def walk(tree, path=()):
            if isinstance(tree, dict):
                return {k: walk(v, path + (k,)) for k, v in tree.items()}
            p = "/".join(path)
            return ((r.rand(*tree.shape) < 0.5).astype(np.float32)
                    if any(m in p for m in MASKED) else None)
        mask = walk(params)
    return cfg, mod.forward, params, D, batches, mask


def _jax_results(name, inputs):
    """JAX's single-device step and its shard_train_step on a virtual
    dp 2 x mp 2 mesh, two steps each, and make_predict_step's predictions
    on batch0's first microbatch."""
    import contextlib
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from clg_vqa_tpu.eval import runner as jrun
    from clg_vqa_tpu.parallel import mesh as pm
    from clg_vqa_tpu.train import loop as jloop
    from clg_vqa_tpu.train.optim import make_optimizer
    cfg, forward, params, D, batches, mask = inputs
    fused = TRAIN_CASES[name][2]
    opt = make_optimizer(params, 1e-3, weight_decay=1e-4, clip_norm=1.0)
    state0 = jloop.TrainState(jax.tree.map(jnp.asarray, params),
                              opt.init(params), jnp.zeros((), jnp.int32))
    # "flat" keeps the kernel's custom VJP on the grad path (use_dropout at
    # rate 0, as tests/test_train.py's flat case)
    step = jloop.make_train_step(forward, cfg, opt, jnp.asarray(D),
                                 semantic_lambda=10.0, top_k=4,
                                 compute_dtype=None, fused_attn=fused,
                                 use_dropout=fused == "flat", grad_mask=mask)
    jb = [jax.tree.map(jnp.asarray, b) for b in batches]
    mesh = pm.make_mesh(n_dp=N_DP, n_mp=N_MP, devices=jax.devices()[:4])
    out = {}
    interp = (pltpu.force_tpu_interpret_mode() if fused
              else contextlib.nullcontext())
    with interp:
        runs = {"single": jax.jit(step)}
        if name not in UNEVEN:
            runs["sharded"] = jloop.shard_train_step(step, mesh, state0, jb[0],
                                                     donate=False)
        for which, fn in runs.items():
            state, metrics = state0, []
            for i, b in enumerate(jb):
                state, m = fn(state, b, jax.random.key(i))
                metrics.append([float(m["loss"]), float(m["grad_norm"])])
            out[which] = (TC.jax_params_to_state_dict(
                jax.tree.map(np.asarray, state.params)), np.array(metrics))
        pred = jrun.make_predict_step(forward, cfg, compute_dtype=None,
                                      fused_attn=fused)
        out["pred"] = np.asarray(pred(state0.params, jax.tree.map(
            lambda x: jnp.asarray(x[0]), batches[0])))
    return out


def _once(tmp_path_factory, name: str, build):
    """build()'s result, computed once per test session: under xdist the
    first worker that asks builds it under a file lock in the session's
    shared temp directory, and every other worker loads its pickle."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return build()
    root = tmp_path_factory.getbasetemp().parent
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            path.write_bytes(pickle.dumps(build()))
        return pickle.loads(path.read_bytes())


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The dp 2 x mp 2 world's results per rank, JAX's per case, and each
    case's JAX (params, grad mask); one spawn a session."""
    return _once(tmp_path_factory, "world4", lambda: _world(tmp_path_factory))


def _world(tmp_path_factory):
    d = tmp_path_factory.mktemp("world4")
    jax_inputs = {name: _jax_inputs(name) for name in TRAIN_CASES}
    arrays = {f"linear/{k}": v for k, v in _linear_inputs().items()}
    for name, (cfg, _, params, D, batches, mask) in jax_inputs.items():
        arrays.update({f"{name}/sd/{k}": v for k, v in
                       TC.jax_params_to_state_dict(params).items()})
        arrays[f"{name}/D"] = D
        for i, b in enumerate(batches):
            arrays.update({f"{name}/b{i}/{k}": v for k, v in b.items()})
        if mask is not None:
            arrays.update({f"{name}/mask/{k}": v for k, v in
                           TC.jax_mask_to_state_dict(mask, params).items()
                           if v is not None})
    np.savez(d / "inputs.npz", **arrays)
    ranks = _spawn(d, N_DP * N_MP, "cases")
    jax_out = {name: _jax_results(name, jax_inputs[name])
               for name in TRAIN_CASES}
    return ranks, jax_out, {name: (params, mask) for name, (
        _, _, params, _, _, mask) in jax_inputs.items()}


@pytest.fixture(scope="module")
def pipeline_world(tmp_path_factory):
    return _once(tmp_path_factory, "world2", lambda: _spawn(
        tmp_path_factory.mktemp("world2"), 2, "pipeline"))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_make_mesh_rejects_non_tiling_shapes(world):
    with pytest.raises(ValueError, match="does not tile"):
        tmesh.make_mesh(n_dp=2, n_mp=3)
    with pytest.raises(ValueError, match="does not tile"):
        tmesh.make_mesh(n_mp=16)                # n_dp == 0
    m = tmesh.make_mesh()                       # one process: a world of one
    assert (m.n_dp, m.n_mp, m.dp_rank, m.mp_rank) == (1, 1, 0, 0)
    ranks, _, _ = world
    for r, out in enumerate(ranks):
        assert "does not tile the 4 available ranks" in str(out["mesh_error"])
        assert tuple(out["ranks"]) == divmod(r, N_MP)     # dp-major


@pytest.mark.parametrize("kind", ["uc2", "m3p"])
def test_param_pspecs_match_jax(kind):
    """Every parameter of the port's UC2 and M3P gets the split of JAX's
    _pspec_for on the same leaf: a JAX [in, out] weight's out axis is the
    port's dim 0, its in axis dim 1; stacked encoder leaves drop [L]."""
    import jax
    from clg_vqa_tpu.config import M3PConfig as JM, UC2Config as JU
    from clg_vqa_tpu.models import m3p as jm3p, uc2 as juc2
    from clg_vqa_tpu.parallel import mesh as pm
    over = UC2_TINY if kind == "uc2" else M3P_TINY
    jcfg = JU(**over) if kind == "uc2" else JM(**over)
    params = (juc2 if kind == "uc2" else jm3p).init_params(jax.random.key(0), jcfg)
    specs = pm.param_pspecs(params)

    def walk(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, path + (k,))
        else:
            yield path, tree

    want = {}
    for path, spec in walk(specs):
        axes = tuple(spec)[1:] if path[0] == "encoder" else tuple(spec)
        axis = next((i for i, a in enumerate(axes) if a == "mp"), None)
        if axis is not None and path[-1] == "w":
            axis = 1 - axis                     # [in, out] -> [out, in]
        for name in TC._port_leaves(path, np.zeros((jcfg.num_layers, 1)))[:1]:
            stem = name[0].split(".", 2)[-1] if path[0] == "encoder" else name[0]
            want[stem] = axis
    model = _port_config(kind, over)
    model = TC.model_class(model)(model, device="cpu")
    got = tmesh.param_pspecs(model)
    assert set(got) == set(model.state_dict())
    for name, dim in got.items():
        stem = name.split(".", 2)[-1] if name.startswith("encoder.") else name
        assert dim == want[stem], name
    assert sum(d is not None for d in got.values()) == 3 + 10 * over["num_layers"]


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_sharded_train_step_matches_jax(world, name):
    """dp 2 x mp 2, fp32, two steps: the port's unsharded parameters,
    losses and grad norms against JAX's single-device step and JAX's
    shard_train_step on a virtual dp 2 x mp 2 mesh (uc2_uneven: the
    single-device step; JAX's sharded step refuses a split that mp does not
    divide)."""
    ranks, jax_out, _ = world
    for which in jax_out[name].keys() - {"pred"}:
        want_sd, want_m = jax_out[name][which]
        for i in range(2):
            got = ranks[0][f"{name}/metrics{i}"]
            np.testing.assert_allclose(got[0], want_m[i, 0], rtol=1e-5)
            np.testing.assert_allclose(got[1], want_m[i, 1], rtol=1e-5)
        for k, v in want_sd.items():
            np.testing.assert_allclose(ranks[0][f"{name}/final/{k}"], v,
                                       rtol=2e-4, atol=1e-5,
                                       err_msg=f"{which} {k}")
    for r in ranks[1:]:         # every rank reassembles the same model
        for k in want_sd:
            np.testing.assert_array_equal(r[f"{name}/final/{k}"],
                                          ranks[0][f"{name}/final/{k}"])
        np.testing.assert_array_equal(r[f"{name}/metrics1"],
                                      ranks[0][f"{name}/metrics1"])


@pytest.mark.parametrize("name", list(TRAIN_CASES)[:4])
def test_sharded_predict_step_matches_jax(world, name):
    """shard_predict_step over dp 2 x mp 2 (False and "flat"; UC2, M3P,
    uneven vocabulary and labels) returns JAX's make_predict_step
    predictions, in batch order, on every rank."""
    ranks, jax_out, _ = world
    for r in ranks:
        np.testing.assert_array_equal(r[f"{name}/pred"], jax_out[name]["pred"])


def test_sharded_steps_refuse_single_chip_routes():
    cfg = UC2Config(**dict(UC2_TINY, hidden_size=128))  # "sm": 128 | H*hd
    model = tmesh.shard_model(UC2(cfg, device="cpu"), tmesh.make_mesh())
    for fused in (True, "hm", "proj", "sm"):
        with pytest.raises(ValueError, match="single-chip"):
            trun.shard_predict_step(model, model.mesh, fused_attn=fused)
    opt = topt.make_optimizer([n for n, _ in model.named_parameters()], 1e-3)
    mp2 = tmesh.Mesh(1, 2, 0, None, None)
    model2 = tmesh.shard_model(UC2(cfg, device="cpu"), mp2)
    batch = _tensors(_batch(0, cfg, (1, 8)))     # "sm": 8 | batch
    for fused in (True, "hm", "proj", "sm"):
        step = tloop.make_train_step(opt, torch.zeros(8, 8), compute_dtype=None,
                                     semantic_lambda=1.0, fused_attn=fused)
        with pytest.raises(ValueError, match="single-chip"):
            tloop.shard_train_step(step, mp2)(
                tloop.TrainState(model2, None, 0), batch, 0)
        _, m = tloop.shard_train_step(step, model.mesh)(   # dp alone takes them
            tloop.TrainState(model, opt.init(dict(model.named_parameters())), 0),
            batch, 0)
        assert np.isfinite(m["loss"].item())
    with pytest.raises(ValueError, match="divisible by mp=4"):
        tmesh.shard_model(UC2(UC2Config(**dict(UC2_TINY, num_heads=2)),
                              device="cpu"), tmesh.Mesh(1, 4, 0, None, None))
    with pytest.raises(ValueError, match="not divisible by dp=2"):
        tmesh.local_batch({"x": torch.zeros(2, 3)}, tmesh.Mesh(2, 1, 0, None, None),
                          microbatched=True)
    with pytest.raises(ValueError, match="laid out for"):
        plain = UC2(cfg, device="cpu")
        tloop.shard_train_step(tloop.make_train_step(
            opt, torch.zeros(8, 8), semantic_lambda=1.0), model.mesh)(
            tloop.TrainState(plain, None, 0), {}, None)


def test_grad_mask_keeps_masked_entries_under_the_mesh(world):
    """A JAX-format 0/1 mask over split (word, q, o, w2, fc2) and replicated
    (pooler) weights: the entries it masks do not move at all."""
    ranks, _, jax_inputs = world
    params, mask = jax_inputs["uc2_mask"]
    start = TC.jax_params_to_state_dict(params)
    n_masked = 0
    for k, m in TC.jax_mask_to_state_dict(mask, params).items():
        if m is None:
            continue
        frozen = m == 0
        n_masked += int(frozen.sum())
        np.testing.assert_array_equal(ranks[0][f"uc2_mask/final/{k}"][frozen],
                                      start[k][frozen], err_msg=k)
        assert not np.array_equal(ranks[0][f"uc2_mask/final/{k}"], start[k]), k
    assert n_masked > 1000


@pytest.mark.parametrize("fused", DROPOUT_ROUTES)
def test_dropout_masks_across_ranks(world, fused):
    """The masks one sharded step realizes: hidden (activation) masks equal
    across the mp ranks of a dp group and different across dp ranks;
    attention keep masks different across both; two runs bit-equal."""
    ranks, _, _ = world
    key = f"dropout_{fused}"

    def masks(r, run, kind):
        pre = f"{key}/run{run}/{kind}"
        keys = [k for k in ranks[r] if k.startswith(pre)]
        return [ranks[r][k] for k in sorted(keys, key=lambda k: int(k[len(pre):] or 0))]

    for r in range(len(ranks)):
        for kind in ("hidden", "attention", "params"):
            a, b = masks(r, 0, kind), masks(r, 1, kind)
            assert len(a) == len(b) > 0
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    # ranks (dp, mp): 0 = (0, 0), 1 = (0, 1), 2 = (1, 0), 3 = (1, 1)
    hidden = [masks(r, 0, "hidden") for r in range(4)]
    attention = [masks(r, 0, "attention") for r in range(4)]
    # embeddings 2, each block 2, the classifier 1, each microbatch
    assert len(hidden[0]) == ACC * (3 + 2 * UC2_TINY["num_layers"])
    assert len(attention[0]) == ACC * UC2_TINY["num_layers"]
    for a, b in ((0, 1), (2, 3)):               # one dp group: the same
        for x, y in zip(hidden[a], hidden[b]):
            np.testing.assert_array_equal(x, y)
    for a, b in ((0, 2), (1, 3)):               # dp ranks: different
        assert all(not np.array_equal(x, y) for x, y in zip(hidden[a], hidden[b]))
    for a in range(4):
        for b in range(a + 1, 4):
            assert all(not np.array_equal(x, y)
                       for x, y in zip(attention[a], attention[b])), (a, b)
    assert 0.85 < np.mean([m.mean() for m in hidden[0]]) < 0.95


def test_shard_train_state_slices_the_moments(world):
    """shard_train_state gives each rank its slices of the AdamW moments
    (vocab 61 and 7 labels over mp 2: 31 + 30 and 4 + 3 rows), which
    mesh.unshard reassembles bit for bit on every rank."""
    ranks, _, _ = world
    for r in ranks:
        keys = [k for k in r if k.startswith("state/mu/")]
        assert len(keys) == len(TC.jax_params_to_state_dict(
            world[2]["uc2_uneven"][0]))
        for k in keys:
            np.testing.assert_array_equal(
                r[k], r[k.replace("state/mu/", "state/whole/")])


def test_megatron_linears_cast_once(world):
    """bf16 at mp 2: the row-parallel output is one cast of (the summed fp32
    partial products + bias) and the column-parallel dx one cast of the
    summed fp32 dx partials, bit for bit; each within one bf16 ulp of the
    single-device linear."""
    ranks, _, _ = world
    inp = {k: torch.from_numpy(v) for k, v in _linear_inputs().items()}
    x, w, b, g = (inp[k] for k in "xwbg")
    bf = torch.bfloat16

    def mm(a, c):
        return torch.mm(a.to(bf).float(), c.to(bf).float())

    y_parts = [mm(x[:, lo:lo + 12], w[:, lo:lo + 12].t()) for lo in (0, 12)]
    want_y = ((y_parts[0] + y_parts[1]) + b).to(bf).float()
    dx_parts = [mm(g[:, lo:lo + 8], w[lo:lo + 8]) for lo in (0, 8)]
    want_dx = (dx_parts[0] + dx_parts[1]).to(bf).float()
    xx = x.clone().requires_grad_()
    single = TL.linear(xx, w, b, bf)
    single.backward(g.to(bf))
    ulp = 2.0 ** (torch.floor(torch.log2(single.float().abs() + 1e-30)) - 7)
    ulp_dx = 2.0 ** (torch.floor(torch.log2(xx.grad.abs() + 1e-30)) - 7)
    for r in ranks:
        y, dx = torch.from_numpy(r["linear/row_y"]), torch.from_numpy(r["linear/col_dx"])
        assert torch.equal(y, want_y) and torch.equal(dx, want_dx)
        assert torch.all((y - single.float()).abs() <= ulp)
        assert torch.all((dx - xx.grad).abs() <= ulp_dx)


def test_two_process_pipeline_step_matches_one_process(pipeline_world):
    """dp 2 over gloo, each rank fed its TrainPipeline(host_id,
    num_hosts=2) rows: the ranks end bit-equal, and within rtol 1e-6 of one
    process trained on the two hosts' rows concatenated (the port of
    tests/test_distributed.py:80-123)."""
    from distributed_worker import SynthDataset
    r0, r1 = pipeline_world
    assert r0["loss"] == r1["loss"]
    np.testing.assert_array_equal(r0["params"], r1["params"])
    cfg = UC2Config(**UC2_TINY, **UC2_OFF)
    hosts = []
    for h in range(2):
        it = TrainPipeline(SynthDataset(64, cfg), micro_batch_size=MBS // 2,
                           grad_acc_steps=ACC, seed=3, host_id=h, num_hosts=2,
                           device_put=False).epoch(0)
        hosts.append(next(it))
        it.close()
    batch = {k: torch.from_numpy(np.concatenate([hosts[0][k], hosts[1][k]], 1))
             for k in hosts[0]}
    model, step, state = _pipeline_world(cfg)
    _, m = step(state, batch, None)
    params = np.concatenate([p.detach().reshape(-1).numpy()
                             for p in model.parameters()])
    np.testing.assert_allclose(float(r0["loss"]), m["loss"].item(), rtol=1e-6)
    np.testing.assert_allclose(np.abs(r0["params"]).sum(dtype=np.float64),
                               np.abs(params).sum(dtype=np.float64), rtol=1e-6)


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
