"""Fault-tolerant, plan-aware GAN training loop. Mirrors
``GanTrainerConfig`` and ``GanTrainer`` of ``repro/train/gan_trainer.py``.

A step is the reference's ``_build_step``: the discriminator's update
against the current generator, then the generator's update against the
updated discriminator; non-saturating softplus losses; AdamW for both nets;
fp32 gradient sums over ``accum`` microbatches taken in a fixed order.

* **Step-atomic checkpoint/resume** every ``ckpt_every`` steps and at exit
  (:mod:`repro_torch.train.checkpoint`). Every input of step ``t`` is a pure
  function of ``(state, t)``: data from ``data.batch(index)``, latents from
  a generator seeded from ``(z_seed, index)``, the bias correction from the
  optimizer's ``count``. A resumed run repeats the uninterrupted one bit for
  bit, provided every kernel sums in a fixed order: the port's kernels do;
  on CUDA, PyTorch's own ops need ``torch.use_deterministic_algorithms(True)``
  and ``CUBLAS_WORKSPACE_CONFIG`` set before the first cuBLAS call.
* **SIGTERM** sets a flag; the loop finishes the step, checkpoints, returns.
* **NaN guard.** One predicate over both losses and both gradient norms:
  a non-finite step keeps the old state objects whole (params, moments,
  ``count``, error feedback; the updates never write in place) and counts
  itself in ``skipped_steps``, which rides in the checkpoint.
* **int8 gradient compression** with error feedback
  (``compress_grads``); the error trees ride in the optimizer state.
* **Elastic degradation**: with ``pods_alive < pods_total`` the microbatch
  shrinks and accumulation makes up the global batch; the step's plan is
  compiled at the microbatch size.

The discriminator phase generates its fakes under ``torch.no_grad()``: its
gradient is taken with respect to the discriminator only, so, as in the
reference (where XLA drops the unused branch), no generator backward runs
there. The step takes ``reals`` and ``zs`` explicitly
(``_step_fn(state, reals, zs)``), so tests can feed the reference's arrays.

Still to port: ``shard_plan_apply`` with the reference's ``data_parallel``
switch, the obs spans, the flight recorder and the fault-injection harness.
"""
from __future__ import annotations

import dataclasses
import signal
import time

import numpy as np
import torch

from repro_torch.data.pipeline import step_generator
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import elastic_batch_schedule
from repro_torch.models import gan
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compression import error_feedback_compress, zero_error_state
from repro_torch.timing import StepTimer
from repro_torch.train.checkpoint import (
    gc_checkpoints,
    place_like,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class GanTrainerConfig:
    """Static trainer configuration."""

    global_batch: int = 8
    opt: AdamWConfig = dataclasses.field(
        default_factory=lambda: AdamWConfig(
            lr=2e-4, b1=0.5, b2=0.999, weight_decay=0.0
        )
    )
    ckpt_every: int = 50
    keep_last: int = 3
    log_every: int = 20
    method: str = "auto"        # plan resolution (see kernels/plan.py)
    z_seed: int = 7
    compress_grads: bool = False  # int8 + error feedback
    pods_alive: int = 1
    pods_total: int = 1

    def __post_init__(self):
        if not (1 <= self.pods_alive <= self.pods_total):
            raise ValueError(
                f"need 1 <= pods_alive <= pods_total, got "
                f"{self.pods_alive}/{self.pods_total}"
            )
        if self.global_batch < 1:
            raise ValueError(f"global_batch must be >= 1, got {self.global_batch}")

    @property
    def micro_accum(self) -> tuple:
        """(per-step microbatch, accumulation steps) under the elastic
        schedule -- ``(global_batch, 1)`` with all pods alive."""
        return elastic_batch_schedule(self.global_batch, self.pods_alive,
                                      self.pods_total)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros_like(x))


class GanTrainer:
    """Plan-aware fault-tolerant GAN trainer (see the module docstring).

    ``data.batch(index) -> (micro, H, W, C)`` must be a pure function of
    ``index`` (e.g. :class:`repro_torch.data.SyntheticImages` at the micro
    batch size). ``hooks`` is an optional object with an
    ``on_step_start(step)`` callback. The trainer runs on ``device``, the
    CUDA card unless the caller names another.
    """

    def __init__(self, cfg, tcfg: GanTrainerConfig, data, *, ckpt_dir=None,
                 hooks=None, log_fn=print, device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.data = data
        self.device = resolve_device(device)
        self.ckpt_dir = str(ckpt_dir) if ckpt_dir is not None else None
        self.hooks = hooks
        self.log = log_fn
        self.micro, self.accum = tcfg.micro_accum
        # the generator's step plan, compiled once at the micro batch size
        self.train_plan = gan.generator_plan(cfg, self.micro, method=tcfg.method)
        self.out_hw = cfg.out_hw(cfg.layers[-1][0])
        self.out_c = cfg.layers[-1][2]
        self.skipped_steps = 0
        self.resumed_step = None
        self.timer = StepTimer()
        self._stop = False

    # ------------------------------------------------------------- state

    def init_state(self, generator: torch.Generator) -> dict:
        """Fresh parameters drawn from ``generator`` (generator first, then
        discriminator) and zero optimizer states."""
        gp = gan.generator_init(generator, self.cfg, device=self.device)
        dp = gan.discriminator_init(generator, self.out_hw, self.out_c,
                                    device=self.device)
        g_opt = adamw_init(gp, self.tcfg.opt)
        d_opt = adamw_init(dp, self.tcfg.opt)
        if self.tcfg.compress_grads:
            g_opt["err"] = zero_error_state(gp)
            d_opt["err"] = zero_error_state(dp)
        return {"g_params": gp, "d_params": dp, "g_opt": g_opt, "d_opt": d_opt}

    # ---------------------------------------------------------- the step

    def _generate(self, gp, z):
        return gan.generator_apply(gp, self.cfg, z, plan=self.train_plan,
                                   device=self.device)

    def _d_loss(self, dp, gp, real, z):
        with torch.no_grad():   # D's gradient only: no generator backward
            fake = self._generate(gp, z)
        return (_softplus(-gan.discriminator_apply(dp, real)).mean()
                + _softplus(gan.discriminator_apply(dp, fake)).mean())

    def _g_loss(self, gp, dp, z):
        fake = self._generate(gp, z)
        return _softplus(-gan.discriminator_apply(dp, fake)).mean()

    @staticmethod
    def _accumulate(loss_fn, params, reals, zs):
        """Mean loss and mean grads (w.r.t. ``params``) over the
        microbatches, summed in fp32 in microbatch order.
        ``loss_fn(params, real, z)``."""
        tot_l = torch.zeros((), device=reals.device)
        tot_g = tree_map(lambda p: torch.zeros(p.shape, device=p.device), params)
        for real, z in zip(reals, zs):
            with torch.enable_grad():
                live = tree_map(lambda p: p.detach().requires_grad_(True), params)
                loss = loss_fn(live, real, z)
                grads = torch.autograd.grad(loss, tree_leaves(live))
            it = iter(grads)
            g = tree_map(lambda _: next(it), live)
            tot_g = tree_map(lambda a, b: a + b.to(torch.float32), tot_g, g)
            tot_l = tot_l + loss.detach()
        n = reals.shape[0]
        return tot_l / n, tree_map(lambda t: t / n, tot_g)

    def _maybe_compress(self, grads, opt_state):
        if not self.tcfg.compress_grads:
            return grads, None
        return error_feedback_compress(grads, opt_state["err"])

    @torch.no_grad()
    def _step_fn(self, state, reals, zs):
        """One training step on ``reals (accum, micro, H, W, C)`` and ``zs
        (accum, micro, z_dim)``: ``(new state, metrics)``."""
        opt = self.tcfg.opt
        gp, dp = state["g_params"], state["d_params"]
        g_opt, d_opt = state["g_opt"], state["d_opt"]

        # D phase: accumulate over micros, update against the current G
        dl, dgrads = self._accumulate(
            lambda dpp, real, z: self._d_loss(dpp, gp, real, z), dp, reals, zs)
        dgrads, d_err = self._maybe_compress(dgrads, d_opt)
        dp_new, d_opt_new, d_gnorm = adamw_update(dgrads, d_opt, dp, opt, opt.lr)

        # G phase: against the UPDATED discriminator
        gl, ggrads = self._accumulate(
            lambda gpp, real, z: self._g_loss(gpp, dp_new, z), gp, reals, zs)
        ggrads, g_err = self._maybe_compress(ggrads, g_opt)
        gp_new, g_opt_new, g_gnorm = adamw_update(ggrads, g_opt, gp, opt, opt.lr)
        if self.tcfg.compress_grads:   # err rides inside the opt state
            d_opt_new = dict(d_opt_new, err=d_err)
            g_opt_new = dict(g_opt_new, err=g_err)

        vals = torch.stack([gl, dl, g_gnorm, d_gnorm]).tolist()
        ok = all(np.isfinite(vals))
        metrics = {"g_loss": vals[0], "d_loss": vals[1], "g_gnorm": vals[2],
                   "d_gnorm": vals[3], "skipped": int(not ok)}
        if not ok:   # the old state, whole: nothing above wrote into it
            return state, metrics
        return {"g_params": gp_new, "d_params": dp_new,
                "g_opt": g_opt_new, "d_opt": d_opt_new}, metrics

    # ------------------------------------------------------------ inputs

    def _batches(self, step: int):
        """The step's stacked ``(accum, micro, ...)`` inputs, each
        microbatch a pure function of its flat index ``step * accum + j``."""
        idx = [step * self.accum + j for j in range(self.accum)]
        reals = torch.stack([self.data.batch(i) for i in idx]).to(self.device)
        zs = torch.stack([
            torch.randn((self.micro, self.cfg.z_dim), device=self.device,
                        generator=step_generator(self.tcfg.z_seed, i, self.device))
            for i in idx
        ])
        return reals, zs

    # ------------------------------------------------------- checkpoints

    def _save(self, step: int, state: dict) -> None:
        save_checkpoint(
            self.ckpt_dir, step,
            {"g": state["g_params"], "d": state["d_params"]},
            {"g": state["g_opt"], "d": state["d_opt"]},
            extra={"skipped_steps": np.int64(self.skipped_steps)},
        )
        gc_checkpoints(self.ckpt_dir, self.tcfg.keep_last)

    def resume(self, state: dict):
        """Restore the newest valid checkpoint onto ``state``'s devices and
        dtypes: ``(start_step, state)``, or ``(0, state)`` untouched when
        no checkpoint loads."""
        if self.ckpt_dir is None:
            return 0, state
        got, p, o, extra = restore_checkpoint(self.ckpt_dir, log_fn=self.log)
        if got is None:
            return 0, state
        state = {
            "g_params": place_like(p["g"], state["g_params"]),
            "d_params": place_like(p["d"], state["d_params"]),
            "g_opt": place_like(o["g"], state["g_opt"]),
            "d_opt": place_like(o["d"], state["d_opt"]),
        }
        if extra is not None and "skipped_steps" in extra:
            self.skipped_steps = int(extra["skipped_steps"])
        self.resumed_step = got
        return got, state

    # ---------------------------------------------------------- the loop

    def _install_sigterm(self):
        def handler(signum, frame):
            self._stop = True  # checkpoint + exit at the next step boundary

        try:
            return signal.signal(signal.SIGTERM, handler)
        except ValueError:
            return None  # not in the main thread

    def run(self, state, *, steps: int):
        """Train to ``steps`` total steps (resuming first): ``(state,
        history)``, one history row ``{"step", "g_loss", "d_loss",
        "skipped"}`` per executed step. SIGTERM checkpoints and returns; a
        crash loses at most the steps since the last checkpoint."""
        self._stop = False
        prev_handler = self._install_sigterm()
        try:
            step, state = self.resume(state)
            if self.resumed_step is not None:
                self.log(f"[gan-trainer] resuming from step {step}")
            history = []
            t0 = time.time()
            self.timer = StepTimer()
            while step < steps and not self._stop:
                if self.hooks is not None:
                    self.hooks.on_step_start(step)
                reals, zs = self._batches(step)
                state, metrics = self._step_fn(state, reals, zs)
                dt = self.timer.tick()
                skipped = metrics["skipped"]
                self.skipped_steps += skipped
                if skipped:
                    self.log(f"[gan-trainer] step {step}: non-finite step; params "
                             f"untouched (total skipped {self.skipped_steps})")
                history.append({"step": step, "g_loss": metrics["g_loss"],
                                "d_loss": metrics["d_loss"], "skipped": skipped})
                if step % self.tcfg.log_every == 0:
                    self.log(f"[gan-trainer] step {step} g_loss "
                             f"{metrics['g_loss']:.4f} d_loss {metrics['d_loss']:.4f} "
                             f"({dt * 1e3:.1f}ms, {time.time() - t0:.1f}s total)")
                if self.ckpt_dir and (step + 1) % self.tcfg.ckpt_every == 0:
                    self._save(step + 1, state)
                step += 1
            if self.ckpt_dir and (self._stop or step >= steps):
                self._save(step, state)
                if self._stop:
                    self.log(f"[gan-trainer] SIGTERM: checkpointed step {step}, "
                             "exiting cleanly")
            return state, history
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)

    # ----------------------------------------------------------- metrics

    @property
    def stopped(self) -> bool:
        """True when the last run exited on SIGTERM rather than completion."""
        return self._stop

    def metrics_summary(self) -> dict:
        return {
            "skipped_steps": self.skipped_steps,
            "resumed_step": self.resumed_step,
            "micro_batch": self.micro,
            "grad_accum": self.accum,
            "steps_timed": len(self.timer.steps),
            "step_time_s": {
                "mean": self.timer.mean() if self.timer.steps else 0.0,
                "median": self.timer.median() if self.timer.steps else 0.0,
            },
        }
