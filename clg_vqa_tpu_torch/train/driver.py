"""The fine-tuning driver (port of clg_vqa_tpu/train/driver.py): the three
recipes of the reference (train_task.py:141-389, train_task_prunning.py:548-877,
train_task_sft.py:331-612), for UC2, M3P, a gated-zoo model or Kimi-VL
(``model_name``, which names the ``.bin`` export's format; the gated zoo
and Kimi-VL run finetune() only, as the IMP recipe's prunable weights are
UC2's and M3P's), over the train step of train/loop.py:
  finetune()  -- the GQA fine-tune: per-epoch and mid-epoch validation with
                 best-params saves;
  imp_prune() -- per round: train under the mask -> global L1 prune of 10%
                 of the survivors -> rewind to theta_0 -> evaluate the
                 rewound theta_0 * mask -> save the round's mask;
  sft()       -- load mask_best, zero the masked weights, train with masked
                 gradients, export the best weights.
All three take resume checkpoints and stop on SIGTERM/SIGINT with a
step-granular resume. The JAX driver's per-layer layout helpers and runtime
masks exist for XLA only and have no counterpart here.
"""
from __future__ import annotations

import json
import os
import signal
import sys
import time
from collections import deque

import torch

from ..config import OptimConfig, TaskConfig
from ..models.layers import fold_seed
from ..utils.logging import MetricsLogger
from . import checkpoints as ckpt
from . import pruning as pr
from .loop import TrainState, make_eval_step, make_train_step, resolve_fused
from .optim import (make_optimizer, warmup_constant_schedule,
                    warmup_linear_schedule)

FUSED_CHOICES = ("auto", "on", "off", "flat", "proj", "sm")


def resolve_train_fused(fused_attn: str, compute_dtype,
                        device: torch.device):
    """The training attention route of a ``--fused_attn`` choice
    (clg_vqa_tpu/train/driver.py:126-146, the TPU read as CUDA): "auto"
    and "on" mean the flat kernel B1 ("on" everywhere, "auto" for bf16 on
    CUDA only), "off" the plain path, "flat", "sm" and "proj" force that
    kernel (B1, B5, the whole-block B4); anything else raises ValueError."""
    if fused_attn not in FUSED_CHOICES:
        raise ValueError(f"fused_attn must be auto/on/off/flat/proj/sm, "
                         f"got {fused_attn!r}")
    if fused_attn in ("on", "off"):
        return "flat" if fused_attn == "on" else False
    return resolve_fused(fused_attn, compute_dtype, device)


class FinetuneRunner:
    """Runs the fine-tuning recipe on ``model``, whose weights are θ0 at the
    start and are trained in place. Everything runs on the model's device.

    Dropout streams: step i (absolute within its epoch) of epoch e draws
    from ``fold_seed(seed * 1000 + e, i)``, and the pipeline's order is a
    function of (seed, epoch), so a run resumed at a recorded step replays
    exactly the streams and batches of the uninterrupted run."""

    def __init__(self, model, train_pipeline, val_dataset, distance_matrix, *,
                 task_cfg: TaskConfig, optim_cfg: OptimConfig,
                 output_dir: str, model_name: str = "uc2",
                 compute_dtype=torch.bfloat16, seed: int = 0,
                 eval_batch_size: int | None = None,
                 eval_steps: int | None = None,
                 train_bank=None, async_ckpt: bool = True,
                 save_every: int = 1, mid_save: str = "none",
                 fused_attn: str = "auto"):
        if model_name not in ("uc2", "m3p", "gated", "kimi_vl"):
            raise ValueError(f"model_name must be 'uc2', 'm3p', 'gated' or "
                             f"'kimi_vl', got {model_name!r}")
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.train_fused = resolve_train_fused(fused_attn, compute_dtype,
                                               self.device)
        if mid_save not in ("none", "params"):
            raise ValueError(f"mid_save must be 'none' or 'params', "
                             f"got {mid_save!r}")
        self.pipe = train_pipeline
        self.val_ds = val_dataset
        n = self.cfg.num_labels
        self.D = (torch.zeros(n, n) if distance_matrix is None
                  else torch.as_tensor(distance_matrix)).float().to(self.device)
        self.task_cfg = task_cfg
        self.optim_cfg = optim_cfg
        self.out = output_dir
        self.model_name = model_name
        self.compute_dtype = compute_dtype
        self.seed = seed
        self.eval_bs = eval_batch_size or task_cfg.eval_batch_size
        self.eval_steps = eval_steps      # mid-epoch eval cadence (optional)
        # the train store on the device: batches carry store indices and
        # the step gathers their features from the bank
        self._bank_tensors = (train_bank.tensors() if train_bank is not None
                              else None)
        # every finished save's {what, path, bytes, seconds}
        self.save_log: list[dict] = []
        # end-of-epoch and best-params saves go through a background writer,
        # so the host copy and the disk write overlap the next steps;
        # preemption saves stay synchronous
        self._saver = ckpt.AsyncSaver(self.save_log) if async_ckpt else None
        # resume-checkpoint cadence: every save_every epochs and always the
        # final one (1 = the reference, train_utils.py:351); mid_save
        # "params" leaves a params-only resume point in the epochs between
        self.save_every = max(int(save_every), 1)
        self.mid_save = mid_save
        os.makedirs(output_dir, exist_ok=True)
        self.logger = MetricsLogger(output_dir, task_cfg.name)
        self._val_bank = None
        self._val_cache = None
        self._lr_table = None             # filled by _build_opt
        if val_dataset is not None:
            try:
                from ..cli.common import maybe_device_bank
                self._val_bank = maybe_device_bank(val_dataset, self.cfg,
                                                   task_cfg, device=self.device)
            except Exception as e:
                # loud: without the bank every eval uploads features per batch
                self._val_bank = None
                print(f"WARNING: val device bank unavailable "
                      f"({type(e).__name__}: {e}); eval falls back to "
                      f"per-batch host feature upload", file=sys.stderr)
        # preemption (absent in the reference, SURVEY.md §5): on SIGTERM or
        # SIGINT finish the current step, checkpoint, then exit
        self._preempted = False
        # recipe context merged into the mid-epoch preemption save
        # (imp_prune stores its round/history cursor here, so a resumed
        # prune re-enters the exact round and step)
        self._preempt_extra: dict | None = None
        # theta_0, the weights the IMP and SFT recipes rewind to: a device
        # copy of the model's state taken when the first of them starts
        self._theta0: dict | None = None
        # test seam: called with the absolute step index after each step
        self._step_callback = None
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, self._on_preempt)
            except ValueError:
                pass        # not the main thread (e.g. under test runners)
        # the flat eval kernel K1 for bf16 at eval batch >= 512 on the card
        # (clg_vqa_tpu/train/driver.py:120-125)
        fused = ("flat" if (compute_dtype == torch.bfloat16
                            and self.eval_bs >= 512
                            and self.device.type == "cuda") else False)
        self.eval_step = make_eval_step(compute_dtype=compute_dtype,
                                        fused_attn=fused)

    def _on_preempt(self, signum, frame):
        self._preempted = True

    # -- plumbing ---------------------------------------------------------

    def _total_steps(self) -> int:
        """Schedule HORIZON, not the trained step count: the reference sizes
        the lr schedule by optim_train_epochs (default 20) while training
        num_epoch (train_task.py:271-274), so a 5-epoch recipe warms up for
        2 epochs and ends at ~0.83x base lr, never 0."""
        return self.pipe.steps_per_epoch() * self.optim_cfg.optim_train_epochs

    def _build_opt(self):
        oc = self.optim_cfg
        total = max(self._total_steps(), 1)
        warmup = int(oc.warmup_proportion * total)
        if oc.lr_scheduler == "warmup_linear":
            sched = warmup_linear_schedule(self.task_cfg.lr, warmup, total)
        else:
            # any other value: WarmupConstantSchedule, the reference's
            # else-branch (train_task.py:273-276)
            sched = warmup_constant_schedule(self.task_cfg.lr, warmup)
        # host lr table for the metrics records
        n = max(self.pipe.steps_per_epoch() * self.task_cfg.num_epoch, 1)
        self._lr_table = [sched(i) for i in range(n + 1)]
        return make_optimizer([k for k, _ in self.model.named_parameters()],
                              sched, b1=oc.adam_betas[0], b2=oc.adam_betas[1],
                              eps=oc.adam_epsilon,
                              weight_decay=oc.weight_decay,
                              correct_bias=oc.correct_bias,
                              clip_norm=oc.clip_grad_norm)

    def _lr_of(self, step: int) -> float:
        """Scheduled lr at optimizer step ``step`` (the reference logs
        param_groups[0]['lr'], train_task.py:341)."""
        t = self._lr_table
        if t is None:
            return float(self.task_cfg.lr)
        return float(t[min(step, len(t) - 1)])

    def _make_step(self, opt, grad_mask=None):
        return make_train_step(
            opt, self.D, semantic_lambda=self.task_cfg.semantic_lambda,
            top_k=self.task_cfg.semantic_top_k,
            compute_dtype=self.compute_dtype, fused_attn=self.train_fused,
            grad_mask=grad_mask, criterion=self.task_cfg.loss)

    def _val_batches(self):
        """Validation batches on the device, assembled once and reused by
        every eval pass. With the device bank a batch is token ids, store
        indices and labels; the eval step gathers the features."""
        if self._val_cache is not None:
            return self._val_cache
        cache = []
        for b in self.val_ds.iter_batches(self.eval_bs,
                                          with_features=self._val_bank is None):
            b.pop("question_id", None)
            # has_label stays: an out-of-vocabulary answer must not score
            # as correct when the argmax is 0
            cache.append({k: torch.from_numpy(v).to(self.device)
                          for k, v in b.items()})
        self._val_cache = cache
        return cache

    def evaluate(self, model, epoch: int) -> float:
        """Val score of ``model``; up to 2 eval batches stay in flight, only
        the oldest batch's metrics wait for the device."""
        if self.val_ds is None:
            return 0.0
        inflight: deque = deque()

        def consume(m):
            self.logger.step_val(float(m["loss"]), float(m["correct"]),
                                 float(m["count"]))

        vbank = (self._val_bank.tensors() if self._val_bank is not None
                 else None)
        for b in self._val_batches():
            inflight.append(self.eval_step(model, b, vbank))
            if len(inflight) > 2:
                consume(inflight.popleft())
        while inflight:
            consume(inflight.popleft())
        return self.logger.show_val(epoch)

    def _train_epoch(self, state, step_fn, epoch, *, log_every=20,
                     start_step=0, best=-1.0, on_best=None,
                     lr_step_base: int = 0):
        """Returns (state, best). A mid-epoch eval (eval_steps cadence) that
        improves on ``best`` updates it and calls on_best(state), as the
        reference saves its best checkpoint mid-epoch (train_task.py:349-356).
        Metrics stay on the device and are fetched in bulk every
        ``log_every`` steps."""
        it = self.pipe.epoch(epoch, start_step=start_step)
        inflight: deque = deque()

        def drain_all():
            if not inflight:
                return
            chunk = list(inflight)
            inflight.clear()
            vals = torch.stack([torch.stack([m["loss"].float(),
                                             m["score"].float()])
                                for _, m in chunk]).tolist()
            for (j, _), (loss, score) in zip(chunk, vals):
                # the lr table is indexed by the optimizer step, which runs
                # on across epochs (lr_step_base)
                self.logger.step_train(epoch, loss, score,
                                       self._lr_of(lr_step_base + j))
            if log_every:
                self.logger.show_train(epoch)

        t0 = None
        n_done = 0
        try:
            for i, batch in enumerate(it, start=start_step):
                state, m = step_fn(state, batch,
                                   fold_seed(self.seed * 1000 + epoch, i),
                                   self._bank_tensors)
                if t0 is None:
                    float(m["loss"])       # the first step builds the kernels
                    t0 = time.perf_counter()
                else:
                    n_done += 1
                inflight.append((i, m))
                if self._step_callback is not None:
                    self._step_callback(i)
                if len(inflight) >= (log_every or 20):
                    drain_all()
                if (self.eval_steps and (i + 1) % self.eval_steps == 0
                        and self.val_ds is not None):
                    score = self.evaluate(state.model, epoch)
                    if score > best:
                        best = score
                        if on_best is not None:
                            on_best(state)
                if self._preempted:
                    # step-granular preemption checkpoint: meta records
                    # (epoch, completed steps), and the resume skips exactly
                    # the completed prefix
                    drain_all()     # the logger's saved state covers step i
                    if self._saver is not None:
                        self._saver.wait()
                    ckpt.save_state(self.out, state, epoch=epoch,
                                    best_score=best,
                                    extra={"logger": self.logger.state_dict(),
                                           "mid_epoch_step": i + 1,
                                           **(self._preempt_extra or {})},
                                    log=self.save_log)
                    raise SystemExit(
                        f"preempted at epoch {epoch} step {i + 1}: "
                        f"state checkpointed to {self.out}")
        finally:
            it.close()
        if inflight:
            float(inflight[-1][1]["loss"])
        dt = time.perf_counter() - t0 if t0 is not None else 0.0
        drain_all()
        if n_done > 0 and dt > 0:
            # integrated throughput: the pipeline feeding the device, the
            # first step excluded
            qa = n_done * self.task_cfg.batch_size / dt
            self.last_epoch_qa_per_sec = qa
            print(f"epoch {epoch}: {n_done} steady-state steps in {dt:.1f}s "
                  f"= {qa:.0f} QA/s integrated")
        self.logger.show_train(epoch)
        return state, best

    # -- checkpoint routing (async by default) ----------------------------

    def _save_params(self, name, model):
        if self._saver is not None:
            self._saver.save_params(self.out, name, model)
        else:
            ckpt.save_params(self.out, name, model, log=self.save_log)

    def _save_state(self, state, **kw):
        if self._saver is not None:
            self._saver.save_state(self.out, state, **kw)
        else:
            ckpt.save_state(self.out, state, log=self.save_log, **kw)

    def _save_epoch_state(self, state, epoch: int, best: float) -> None:
        """End-of-epoch resume checkpoint: the full state on the save_every
        cadence and on the final epoch; a params-only save for the epochs
        between when mid_save="params" (nothing otherwise)."""
        full = ((epoch + 1) % self.save_every == 0
                or epoch == self.task_cfg.num_epoch - 1)
        if full or self.mid_save == "params":
            self._save_state(state, epoch=epoch, best_score=best,
                             extra={"logger": self.logger.state_dict()},
                             params_only=not full)

    def export_torch(self, name: str) -> None:
        """The model as a VOLTA ``.bin`` under the output directory."""
        path = os.path.join(self.out, name)
        if self._saver is not None:
            self._saver.export_torch_bin(path, self.model, self.model_name,
                                         cfg=self.cfg)
        else:
            ckpt.export_torch_bin(path, self.model, self.model_name,
                                  cfg=self.cfg, log=self.save_log)

    def flush_saves(self):
        if self._saver is not None:
            self._saver.wait()

    # -- recipes ----------------------------------------------------------

    def _resume_meta(self, state):
        """(state, start_epoch, start_step, best) from the latest checkpoint.
        A meta with 'mid_epoch_step' re-enters that epoch at the recorded
        step; an end-of-epoch meta starts the next epoch."""
        state, meta = ckpt.resume_state(self.out, state)
        if meta.get("params_only"):
            print("WARNING: resuming from a params-only (mid_save) "
                  "checkpoint: optimizer moments restart at zero (schedule "
                  "clock fast-forwarded); training is NOT bit-identical to "
                  "an uninterrupted run", file=sys.stderr)
        self.logger.load_state_dict(meta.get("logger", {}))
        best = meta["best_score"]
        if meta.get("mid_epoch_step"):
            return state, meta["epoch"], meta["mid_epoch_step"], best
        return state, meta["epoch"] + 1, 0, best

    def _fresh_state(self, opt) -> TrainState:
        """The model with fresh optimizer moments at step 0."""
        return TrainState(self.model,
                          opt.init(dict(self.model.named_parameters())), 0)

    def _fresh_theta0(self) -> None:
        """Rewind: copy theta_0 into the model's parameters in place. The
        snapshot is taken once, when the first IMP or SFT recipe of this
        runner starts and before any resume load, so every round of every
        recipe rewinds to the same weights."""
        if self._theta0 is None:
            self._theta0 = {k: v.detach().clone()
                            for k, v in self.model.state_dict().items()}
        self.model.load_state_dict(self._theta0)

    def finetune(self, *, resume: bool = False) -> float:
        """The fine-tune recipe; returns the best val score."""
        opt = self._build_opt()
        step_fn = self._make_step(opt)
        state = self._fresh_state(opt)
        start_epoch, start_step, best = 0, 0, -1.0
        if resume:
            try:
                state, start_epoch, start_step, best = self._resume_meta(state)
            except FileNotFoundError:
                pass
        for epoch in range(start_epoch, self.task_cfg.num_epoch):
            state, best = self._train_epoch(
                state, step_fn, epoch, best=best,
                start_step=start_step if epoch == start_epoch else 0,
                on_best=lambda s: self._save_params("params_best", s.model),
                lr_step_base=epoch * self.pipe.steps_per_epoch())
            score = self.evaluate(state.model, epoch)
            if score > best:
                best = score
                self._save_params("params_best", state.model)
            self._save_epoch_state(state, epoch, best)
        self.flush_saves()
        return best

    # -- prune-resume plumbing ---------------------------------------------
    # Two levels, as in the JAX driver (clg_vqa_tpu/train/driver.py:451-522):
    # prune_meta.json records every completed ROUND (no train state: the
    # next round rewinds to theta_0, and the round's mask is on disk as
    # mask_lt{r}.npz), while a mid-round SIGTERM rides the step-granular
    # state checkpoint with the prune cursor merged in (_preempt_extra), so
    # a resume is bit-exact.

    def _prune_meta_path(self) -> str:
        return os.path.join(self.out, "prune_meta.json")

    def _write_prune_meta(self, next_round: int, history: list,
                          best: float, best_epoch: int) -> None:
        tmp = self._prune_meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"next_round": next_round, "history": history,
                       "best_score": best, "best_epoch": best_epoch,
                       "logger": self.logger.state_dict()}, f)
        os.replace(tmp, self._prune_meta_path())

    def _round_input_mask(self, rnd: int):
        """The mask prune round ``rnd`` trains under: round rnd-1's output
        (mask_lt{rnd-1}.npz), or the all-ones init for round 0."""
        if rnd <= 0:
            return pr.init_mask(self.model, self.model_name)
        return pr.load_mask(os.path.join(self.out, f"mask_lt{rnd - 1}.npz"),
                            self.model, self.model_name)

    def _resume_prune(self, opt):
        """(mask, start_round, start_step, mid_state, history, best,
        best_epoch) from the prune artifacts on disk; defaults if none."""
        mask = pr.init_mask(self.model, self.model_name)
        start_round, start_step, mid_state = 0, 0, None
        history, best, best_epoch = [], -1.0, -1
        if os.path.exists(self._prune_meta_path()):
            with open(self._prune_meta_path()) as f:
                pmeta = json.load(f)
            start_round = pmeta["next_round"]
            history = pmeta["history"]
            best, best_epoch = pmeta["best_score"], pmeta["best_epoch"]
            self.logger.load_state_dict(pmeta.get("logger", {}))
            mask = self._round_input_mask(start_round)
        # a mid-round state supersedes the round record only if its round
        # is not already complete (prune_meta is written after each round,
        # so a state checkpoint from an earlier round is stale)
        meta_path = os.path.join(self.out, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                smeta = json.load(f)
            pcur = smeta.get("prune")
            if (pcur is not None and smeta.get("mid_epoch_step")
                    and pcur["round"] >= start_round):
                mid_state, smeta = ckpt.resume_state(self.out,
                                                     self._fresh_state(opt))
                self.logger.load_state_dict(smeta.get("logger", {}))
                start_round = pcur["round"]
                start_step = smeta["mid_epoch_step"]
                history = pcur["history"]
                best, best_epoch = pcur["best_score"], pcur["best_epoch"]
                mask = self._round_input_mask(start_round)
        return mask, start_round, start_step, mid_state, history, best, \
            best_epoch

    def _check_prunable(self) -> None:
        if self.model_name in ("gated", "kimi_vl"):
            raise ValueError(f"the IMP / SFT recipes prune UC2's and M3P's "
                             f"encoder weights (train/pruning.py); a "
                             f"{self.model_name} model has none of them (IMP "
                             f"masks for experts are not implemented)")

    def imp_prune(self, *, fraction: float = 0.1,
                  resume: bool = False) -> dict:
        """IMP: ``task_cfg.num_epoch`` rounds. Each trains one epoch from
        theta_0 * mask under the mask with a fresh optimizer and schedule
        (train_task_prunning.py:791-866), prunes ``fraction`` of the
        survivors, rewinds to theta_0 and evaluates the rewound theta_0 *
        mask, which picks mask_best (the reference's order, :791-877).
        Writes mask_lt{r}.npz, mask_best.npz and prune_meta.json; returns
        {best_score, best_epoch, history}."""
        self._check_prunable()
        self._fresh_theta0()
        opt = self._build_opt()
        mask = pr.init_mask(self.model, self.model_name)
        start_round, start_step, mid_state = 0, 0, None
        history, best, best_epoch = [], -1.0, -1
        if resume:
            (mask, start_round, start_step, mid_state, history, best,
             best_epoch) = self._resume_prune(opt)
        for epoch in range(start_round, self.task_cfg.num_epoch):
            self._preempt_extra = {"prune": {
                "round": epoch, "history": history,
                "best_score": best, "best_epoch": best_epoch}}
            if mid_state is not None and epoch == start_round:
                state, s0 = mid_state, start_step
            else:
                self._fresh_theta0()
                pr.apply_mask(self.model, mask)
                state, s0 = self._fresh_state(opt), 0
            state, _ = self._train_epoch(
                state, self._make_step(opt, pr.grad_mask_tree(mask)), epoch,
                start_step=s0)
            mask = pr.imp_prune_step(self.model, mask, fraction)
            sp = pr.sparsity(mask)
            self._fresh_theta0()
            pr.apply_mask(self.model, mask)
            score = self.evaluate(self.model, epoch)
            history.append({"epoch": epoch, "sparsity": sp, "score": score})
            pr.save_mask(os.path.join(self.out, f"mask_lt{epoch}.npz"), mask)
            if score > best:
                best, best_epoch = score, epoch
                pr.save_mask(os.path.join(self.out, "mask_best.npz"), mask)
            self._write_prune_meta(epoch + 1, history, best, best_epoch)
        self._preempt_extra = None
        return {"best_score": best, "best_epoch": best_epoch,
                "history": history}

    def sft(self, mask_path: str, *, resume: bool = False) -> float:
        """SFT: load the mask, rewind to theta_0 * mask, train with masked
        gradients (the reference's CustomFromMask reparametrization); each
        best val score saves params_best and exports model_best_sft.bin.
        Returns the best val score."""
        self._check_prunable()
        mask = pr.load_mask(mask_path, self.model, self.model_name)
        self._fresh_theta0()
        pr.apply_mask(self.model, mask)
        opt = self._build_opt()
        step_fn = self._make_step(opt, pr.grad_mask_tree(mask))
        state = self._fresh_state(opt)
        start_epoch, start_step, best = 0, 0, -1.0
        if resume:
            try:
                state, start_epoch, start_step, best = self._resume_meta(state)
            except FileNotFoundError:
                pass

        def save_best(s):
            self._save_params("params_best", s.model)
            self.export_torch("model_best_sft.bin")

        for epoch in range(start_epoch, self.task_cfg.num_epoch):
            state, best = self._train_epoch(
                state, step_fn, epoch, best=best,
                start_step=start_step if epoch == start_epoch else 0,
                on_best=save_best,
                lr_step_base=epoch * self.pipe.steps_per_epoch())
            score = self.evaluate(state.model, epoch)
            if score > best:
                best = score
                save_best(state)
            self._save_epoch_state(state, epoch, best)
        self.flush_saves()
        return best
