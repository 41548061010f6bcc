"""Fault-tolerant, plan-aware GAN training loop. Mirrors
``GanTrainerConfig`` and ``GanTrainer`` of ``repro/train/gan_trainer.py``.

A step is the reference's ``_build_step``: the discriminator's update
against the current generator, then the generator's update against the
updated discriminator; non-saturating softplus losses; AdamW for both nets;
fp32 gradient sums over ``accum`` microbatches taken in a fixed order.

**Objectives.** ``objective="classifier"`` is the above, the reference's:
the small conv discriminator's logits under softplus losses.
``objective="energy"`` is EB-GAN's (arXiv:1609.03126, section 2): the
discriminator is an auto-encoder (:func:`~repro_torch.models.gan.autoencoder_init`,
at :func:`~repro_torch.models.gan.autoencoder_widths`) whose decoder runs the port's transpose-conv kernels
on train-mode plans, a sample's energy ``D(x)`` its reconstruction's mean
squared error, and

    L_D = mean D(real) + mean max(0, margin - D(G(z)))
    L_G = mean D(G(z)) + pt_weight * f_PT(Enc(G(z)))

with the pulling-away term ``f_PT`` (:func:`~repro_torch.models.gan.pulling_away`).
The discriminator's phase runs the auto-encoder once on the real and fake
rows together (``2 * micro`` rows). The step's read-back then carries four
more scalars (:data:`ENERGY_STATS`: the phase's mean real and fake
energies, the share of fake rows under the margin, whose hinge is live,
and the generator phase's pulling-away term), in the same one copy.

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

**One executable a step.** On the card the whole step -- both phases,
AdamW for both nets, the optional compression, the four scalars -- is one
CUDA graph (:mod:`repro_torch.graphs`), the counterpart of the reference's
``jax.jit(step, donate_argnums=(0,))``, captured at the first step (so a
``train_plan`` set after construction is the one captured). The state is
donated: the state a step returns is the trainer's static buffer, which
the next step overwrites in place, so a caller who keeps an older state
clones it; a state that is not that buffer (a fresh ``init_state``, one
``resume`` placed) is copied in. The host reads the four scalars after the
replay, and only a step whose scalars are all finite copies the graph's
new state into the buffer. On the CPU the step runs eagerly and returns
new tensors.

**Observability** (:mod:`repro_torch.obs`), as in the reference: while
tracing is enabled each step records the spans ``train.step`` (the hook,
the inputs and the step), ``train.batch`` (drawing the inputs) and
``train.step_fn`` (the graph's replay and the read-back of the four
scalars, the step's one sync), the observation ``train.step_s`` and the
counters ``train.steps`` and ``train.skipped_steps``. The port splits
``train.step_fn`` into ``train.launch`` (the static copies and the
replay), ``train.readback`` (the scalars' read-back) and ``train.commit``
(the NaN guard and the state's copy), and records a collector pass during
:meth:`GanTrainer.run` as ``host.gc`` (``host.gc.hook`` marks the hook;
:data:`PORT_SPANS`). An optional
:class:`~repro_torch.obs.flight_recorder.FlightRecorder` (``recorder=``)
records every step and dumps on a NaN-guard skip (``nan_guard``), on an
exception (``crash:<ExcType>``) and after SIGTERM's checkpoint
(``sigterm``). The fault-injection harness is
:mod:`repro_torch.train.fault_injection`.

**Data parallelism** (``data_parallel``, on by default, as in the
reference): the generator runs through
:func:`~repro_torch.distributed.sharding.shard_plan_apply`, split over the
data-parallel ranks of the ambient ``DeviceMesh``
(:func:`~repro_torch.distributed.sharding.use_mesh`); with no mesh it is
the unsharded call, bit for bit. Every rank draws the same global batch and
holds the whole state; the region's collectives sum the generator's
gradients over the ranks, so the step has no gradient all-reduce of its
own and every rank makes the same update. On the card the step's CUDA graph
captures those collectives, so the mesh's groups must be NCCL: the
trainer checks that at construction and runs one collective before any
capture (a CUDA trainer under a mesh of another backend raises; nothing
runs eagerly instead). Only global rank 0 writes checkpoints; every rank
restores.
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
from repro_torch.distributed.sharding import (
    check_capturable,
    get_concrete_mesh,
    is_writer,
    shard_plan_apply,
)
from repro_torch.graphs import CudaGraph
from repro_torch.models import gan
from repro_torch.obs import trace as obs
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

# the spans the port records beyond the reference's (module docstring)
PORT_SPANS = frozenset(("train.launch", "train.readback", "train.commit",
                        "host.gc", "host.gc.hook"))
OBJECTIVES = ("classifier", "energy")
# the energy objective's read-back beyond the four scalars, in its order;
# each is recorded as the gauge ``train.<name>`` while tracing is on
ENERGY_STATS = ("energy_real", "energy_fake", "margin_active", "pt")


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
    data_parallel: bool = True    # shard_plan_apply when a mesh is active
    objective: str = "classifier"   # or "energy" (module docstring)
    margin: float | None = None     # energy: the hinge's margin m (required)
    pt_weight: float = 0.1          # energy: the pulling-away term's weight

    def __post_init__(self):
        if self.objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {self.objective!r}; one of {OBJECTIVES}")
        if self.objective == "energy" and self.margin is None:
            raise ValueError("the energy objective needs its margin")
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
    ``on_step_start(step)`` callback (the seam
    :class:`~repro_torch.train.fault_injection.FaultInjector` drives).
    ``recorder`` is an optional flight recorder. The trainer runs on
    ``device``, the CUDA card unless the caller names another.
    """

    def __init__(self, cfg, tcfg: GanTrainerConfig, data, *, ckpt_dir=None,
                 hooks=None, log_fn=print, device=None, recorder=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.data = data
        self.device = resolve_device(device)
        self.ckpt_dir = str(ckpt_dir) if ckpt_dir is not None else None
        self.hooks = hooks
        self.log = log_fn
        self.recorder = recorder
        self.micro, self.accum = tcfg.micro_accum
        # the generator's step plan, compiled once at the micro batch size
        self.train_plan = gan.generator_plan(cfg, self.micro, train=True,
                                             method=tcfg.method)
        self.out_hw = cfg.image_hw
        self.out_c = cfg.image_channels
        self.energy = tcfg.objective == "energy"
        if self.energy:
            # the auto-encoder's decoder, planned for the discriminator's
            # phase (real and fake rows) and the generator's (fake rows)
            self.ae_widths = gan.autoencoder_widths(cfg)
            self.dec_cfg = gan.decoder_config(self.out_hw, self.out_c, self.ae_widths)
            self.dec_plans = tuple(
                gan.generator_plan(self.dec_cfg, rows, train=True, method=tcfg.method)
                for rows in (2 * self.micro, self.micro))
        self.skipped_steps = 0
        self.resumed_step = None
        self.timer = StepTimer()
        self._stop = False
        self._graph = None          # the step's CUDA graph, at the first step
        self._graph_plan = None     # the train_plan it captured
        self._graph_mesh = None     # the ambient mesh it captured
        if tcfg.data_parallel and self.device.type == "cuda":
            check_capturable(get_concrete_mesh(), self.device)

    # ------------------------------------------------------------- state

    def init_state(self, generator: torch.Generator) -> dict:
        """Fresh parameters drawn from ``generator`` (generator first, then
        discriminator) and zero optimizer states."""
        gp = gan.generator_init(generator, self.cfg, device=self.device)
        if self.energy:
            dp = gan.autoencoder_init(generator, self.out_hw, self.out_c,
                                      self.ae_widths, device=self.device)
        else:
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
        if self.tcfg.data_parallel:
            return shard_plan_apply(
                lambda p, zz, plan: gan.generator_apply(p, self.cfg, zz, plan=plan,
                                                        device=self.device),
                gp, z, self.train_plan)
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

    def _d_loss_energy(self, dp, gp, real, z):
        """EB-GAN's discriminator loss and ``[mean D(real), mean D(fake),
        share of fake rows under the margin]``; real and fake rows go
        through the auto-encoder as one batch."""
        with torch.no_grad():   # D's gradient only: no generator backward
            fake = self._generate(gp, z)
        e, _ = gan.energy(dp, self.dec_cfg, torch.cat([real, fake]),
                          plan=self.dec_plans[0])
        e_real, e_fake = e[: real.shape[0]], e[real.shape[0]:]
        m = self.tcfg.margin
        loss = e_real.mean() + torch.relu(m - e_fake).mean()
        aux = torch.stack([e_real.mean(), e_fake.mean(), (e_fake < m).float().mean()])
        return loss, aux.detach()

    def _g_loss_energy(self, gp, dp, z):
        """EB-GAN's generator loss and ``[f_PT]``: the fakes' energy and the
        pulling-away term of their codes."""
        fake = self._generate(gp, z)
        e, code = gan.energy(dp, self.dec_cfg, fake, plan=self.dec_plans[1])
        pt = gan.pulling_away(code)
        return e.mean() + self.tcfg.pt_weight * pt, pt.detach()[None]

    @staticmethod
    def _accumulate(loss_fn, params, reals, zs):
        """Mean loss, mean grads (w.r.t. ``params``) and mean auxiliary
        values over the microbatches, summed in fp32 in microbatch order.
        ``loss_fn(params, real, z)`` returns the loss, or ``(loss, aux)``
        with ``aux`` a tensor of values to average (None without)."""
        tot_l = torch.zeros((), device=reals.device)
        tot_g = tree_map(lambda p: torch.zeros(p.shape, device=p.device), params)
        tot_a = None
        for real, z in zip(reals, zs):
            with torch.enable_grad():
                live = tree_map(lambda p: p.detach().requires_grad_(True), params)
                loss = loss_fn(live, real, z)
                if isinstance(loss, tuple):
                    loss, aux = loss
                    tot_a = aux if tot_a is None else tot_a + aux
                grads = torch.autograd.grad(loss, tree_leaves(live))
            it = iter(grads)
            g = tree_map(lambda _: next(it), live)
            tot_g = tree_map(lambda a, b: a + b.to(torch.float32), tot_g, g)
            tot_l = tot_l + loss.detach()
        n = reals.shape[0]
        return (tot_l / n, tree_map(lambda t: t / n, tot_g),
                None if tot_a is None else tot_a / n)

    def _maybe_compress(self, grads, opt_state):
        if not self.tcfg.compress_grads:
            return grads, None
        return error_feedback_compress(grads, opt_state["err"])

    @torch.no_grad()
    def _step_eager(self, state, reals, zs):
        """One training step on ``reals (accum, micro, H, W, C)`` and ``zs
        (accum, micro, z_dim)``: ``(new state, stats)``, ``stats`` the
        device tensor ``[g_loss, d_loss, g_gnorm, d_gnorm]`` (then
        :data:`ENERGY_STATS` for the energy objective). It reads
        nothing back to the host and writes into none of its inputs, so the
        step's CUDA graph captures it whole (:meth:`_step_fn`)."""
        opt = self.tcfg.opt
        gp, dp = state["g_params"], state["d_params"]
        g_opt, d_opt = state["g_opt"], state["d_opt"]

        d_loss = self._d_loss_energy if self.energy else self._d_loss
        g_loss = self._g_loss_energy if self.energy else self._g_loss

        # D phase: accumulate over micros, update against the current G
        dl, dgrads, d_aux = self._accumulate(
            lambda dpp, real, z: d_loss(dpp, gp, real, z), dp, reals, zs)
        dgrads, d_err = self._maybe_compress(dgrads, d_opt)
        dp_new, d_opt_new, d_gnorm = adamw_update(dgrads, d_opt, dp, opt, opt.lr)

        # G phase: against the UPDATED discriminator
        gl, ggrads, g_aux = self._accumulate(
            lambda gpp, real, z: g_loss(gpp, dp_new, z), gp, reals, zs)
        ggrads, g_err = self._maybe_compress(ggrads, g_opt)
        gp_new, g_opt_new, g_gnorm = adamw_update(ggrads, g_opt, gp, opt, opt.lr)
        if self.tcfg.compress_grads:   # err rides inside the opt state
            d_opt_new = dict(d_opt_new, err=d_err)
            g_opt_new = dict(g_opt_new, err=g_err)

        stats = torch.stack([gl, dl, g_gnorm, d_gnorm])
        if self.energy:
            stats = torch.cat([stats, d_aux, g_aux])
        return ({"g_params": gp_new, "d_params": dp_new,
                 "g_opt": g_opt_new, "d_opt": d_opt_new}, stats)

    def _step_graph(self, state, reals, zs) -> CudaGraph:
        """The step's CUDA graph, captured at the first CUDA step over
        static copies of the state and the inputs. Its warm-up runs one
        step eagerly and drops the result: :meth:`_step_eager` writes into
        none of its inputs, so the warm-up advances no state."""
        if self._graph is None:
            self._graph_plan = self.train_plan
            self._graph_mesh = get_concrete_mesh()
            self._graph = CudaGraph(self._step_eager, state, reals, zs)
        elif self._graph_plan is not self.train_plan:
            raise ValueError("train_plan was replaced after the step's CUDA graph "
                             "was captured; set it before the first step")
        elif self.tcfg.data_parallel and self._graph_mesh is not get_concrete_mesh():
            raise ValueError("the ambient mesh changed after the step's CUDA graph "
                             "was captured under another")
        return self._graph

    def _step_fn(self, state, reals, zs):
        """One training step (:meth:`_step_eager`) behind the NaN guard:
        ``(state, metrics)``. On the card it replays the step's graph and
        returns the static state buffer, into which the new state was
        copied only if the step was finite (see the module docstring); on
        the CPU it returns the new state, or ``state`` itself."""
        tracing = obs.enabled()
        with obs.span("train.launch") if tracing else obs.NOOP_SPAN:
            if self.device.type == "cuda":
                graph = self._step_graph(state, reals, zs)
                new, stats = graph(state, reals, zs)
                state = graph.inputs[0]   # the donated buffer, the caller's state in it
            else:
                new, stats = self._step_eager(state, reals, zs)
        with obs.span("train.readback") if tracing else obs.NOOP_SPAN:
            vals = stats.tolist()
        with obs.span("train.commit") if tracing else obs.NOOP_SPAN:
            ok = all(np.isfinite(vals))
            metrics = {"g_loss": vals[0], "d_loss": vals[1], "g_gnorm": vals[2],
                       "d_gnorm": vals[3], "skipped": int(not ok)}
            if self.energy:
                metrics.update(zip(ENERGY_STATS, vals[4:]))
                if tracing:
                    for name in ENERGY_STATS:
                        obs.gauge(f"train.{name}", metrics[name])
            if not ok:   # the old state, whole: nothing wrote into it
                return state, metrics
            if self.device.type == "cuda":   # commit the graph's new state
                torch._foreach_copy_(tree_leaves(state), tree_leaves(new))
                return state, metrics
            return new, metrics

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
        if not is_writer():
            return
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
        "skipped"}`` per executed step (and :data:`ENERGY_STATS` for the
        energy objective). SIGTERM checkpoints and returns; a
        crash loses at most the steps since the last checkpoint."""
        self._stop = False
        prev_handler = self._install_sigterm()
        gc_spans = obs.GcSpans()
        try:
            step, state = self.resume(state)
            if self.resumed_step is not None:
                self.log(f"[gan-trainer] resuming from step {step}")
            history = []
            t0 = time.time()
            self.timer = StepTimer()
            try:
                while step < steps and not self._stop:
                    tracing = obs.enabled()
                    if tracing and not gc_spans.installed:
                        gc_spans.install()
                    with (obs.span("train.step", step=step) if tracing
                          else obs.NOOP_SPAN):
                        if self.hooks is not None:
                            self.hooks.on_step_start(step)
                        with (obs.span("train.batch", step=step) if tracing
                              else obs.NOOP_SPAN):
                            reals, zs = self._batches(step)
                        with (obs.span("train.step_fn", step=step) if tracing
                              else obs.NOOP_SPAN):
                            state, metrics = self._step_fn(state, reals, zs)
                    dt = self.timer.tick()
                    if tracing:
                        obs.observe("train.step_s", dt)
                        obs.counter("train.steps")
                    skipped = metrics["skipped"]
                    self.skipped_steps += skipped
                    if self.recorder is not None:
                        self.recorder.record(
                            "train.step", step=step, dt=dt, skipped=skipped,
                            g_loss=metrics["g_loss"], d_loss=metrics["d_loss"])
                    if skipped:
                        if tracing:
                            obs.counter("train.skipped_steps")
                        if self.recorder is not None:
                            self.recorder.dump("nan_guard", extra={
                                "step": step, "skipped_total": self.skipped_steps})
                        self.log(f"[gan-trainer] step {step}: non-finite step; params "
                                 f"untouched (total skipped {self.skipped_steps})")
                    row = {"step": step, "g_loss": metrics["g_loss"],
                           "d_loss": metrics["d_loss"], "skipped": skipped}
                    if self.energy:
                        row.update((k, metrics[k]) for k in ENERGY_STATS)
                    history.append(row)
                    if step % self.tcfg.log_every == 0:
                        self.log(f"[gan-trainer] step {step} g_loss "
                                 f"{metrics['g_loss']:.4f} d_loss "
                                 f"{metrics['d_loss']:.4f} ({dt * 1e3:.1f}ms, "
                                 f"{time.time() - t0:.1f}s total)")
                    if self.ckpt_dir and (step + 1) % self.tcfg.ckpt_every == 0:
                        self._save(step + 1, state)
                    step += 1
            except Exception as e:
                # the post-mortem artifact before the crash propagates; at
                # most the steps since the last checkpoint are lost
                if self.recorder is not None:
                    self.recorder.record("crash", step=step, error=type(e).__name__)
                    self.recorder.dump(f"crash:{type(e).__name__}",
                                       extra={"step": step, "error": str(e)})
                raise
            if self.ckpt_dir and (self._stop or step >= steps):
                self._save(step, state)
                if self._stop:
                    self.log(f"[gan-trainer] SIGTERM: checkpointed step {step}, "
                             "exiting cleanly")
            if self._stop and self.recorder is not None:
                # after the final save, so the dump reflects durable state
                self.recorder.record("sigterm", step=step)
                self.recorder.dump("sigterm", extra={"step": step})
            return state, history
        finally:
            gc_spans.remove()
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
