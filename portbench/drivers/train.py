"""The training driver: the program's ``GanTrainer`` at the configuration's
batch, fed the program's ``SyntheticImages`` and its seeded latents.

Set-up draws the weights, builds the trainer and its state, and drives that
same object through the window's own entry, ``GanTrainer.run``: once for
one step (which captures the step's CUDA graph; the first moments are read
after it), then for three steps, which start again at step 0 (``run``
starts at 0 without a checkpoint). Those four steps, on the feed's batches
0, 0, 1 and 2, are the ones the reference follows. The window is
``GanTrainer.run`` on the same trainer and state until ``--seconds`` have
passed: at the first step that starts after that, the harness sends the
trainer the SIGTERM it stops on, and the step in flight completes. The rate
counts every sample of every step the window ran over the window's wall.
"""
from __future__ import annotations

import os
import signal
import statistics
import time

import torch

from portbench import devtrace, inputs, work
from portbench.drivers import common
from portbench.reference import gan as ref

# the feed's batch of each checked step: run(steps=1), then run(steps=3)
CHECK_BATCHES = (0, 0, 1, 2)


class _Hook:
    """The trainer's step hook: starts the profiled sub-window, which runs
    to the window's close, and ends the window with SIGTERM once its
    seconds have passed and, in a traced run, the sub-window holds a step
    that began with the spans on (the step that starts them read them off)."""

    def __init__(self, seconds: float, profile, profile_from: float):
        self.seconds, self.profile, self.profile_from = seconds, profile, profile_from
        self.t0 = None
        self.stopping = False
        self.profiled_steps = 0     # steps that started while profiling

    def on_step_start(self, step: int) -> None:
        if self.t0 is None:
            return
        rel = time.monotonic() - self.t0
        p = self.profile
        if p is not None:
            if p.t0 is None and rel >= self.profile_from * self.seconds:
                common.start_profile(p)
            if p.t0 is not None:
                self.profiled_steps += 1
        if rel >= self.seconds and not self.stopping and (p is None or self.profiled_steps > 1):
            self.stopping = True
            os.kill(os.getpid(), signal.SIGTERM)


def z_seed(seed: int) -> int:
    return seed + 1


def run(cell) -> common.Outcome:
    from repro_torch.data.pipeline import SyntheticImages
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.gan_trainer import GanTrainer, GanTrainerConfig

    dev = torch.device(cell.device)
    cfg, mix = cell.cfg, cell.mix
    gan = work.Gan(cfg)
    batch = cfg["train"]["global_batch"]
    o = cfg["train"]["optimizer"]
    opt = AdamWConfig(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                      weight_decay=o["weight_decay"],
                      clip_norm=float("inf") if o["clip_norm"] is None else o["clip_norm"])
    tcfg = GanTrainerConfig(global_batch=batch, opt=opt, ckpt_every=1 << 30,
                            log_every=1 << 30, z_seed=z_seed(cell.seed))
    data = SyntheticImages(gan.out_hw, gan.out_c, batch, seed=cell.seed, device=dev)
    profile = devtrace.Profile() if cell.trace else None
    hook = _Hook(cell.seconds, profile, mix["profile_from"])
    trainer = GanTrainer(common.gan_config(cfg), tcfg, data, device=dev, hooks=hook,
                         log_fn=lambda *a: None)
    gp, dp = inputs.weights(cfg, cell.seed, dev, discriminator=True)
    state = {"g_params": gp, "d_params": dp, "g_opt": adamw_init(gp, opt),
             "d_opt": adamw_init(dp, opt)}
    gp = dp = None

    state, history = trainer.run(state, steps=1)
    m1 = {**{f"g.{k}": v.cpu() for k, v in common.flatten(state["g_opt"]["m"]).items()},
          **{f"d.{k}": v.cpu() for k, v in common.flatten(state["d_opt"]["m"]).items()}}
    state, more = trainer.run(state, steps=len(CHECK_BATCHES) - 1)
    history += more
    losses = [(h["g_loss"], h["d_loss"]) for h in history]
    skipped = sum(h["skipped"] for h in history)
    params = {**{f"g.{k}": v.cpu() for k, v in common.flatten(state["g_params"]).items()},
              **{f"d.{k}": v.cpu() for k, v in common.flatten(state["d_params"]).items()}}
    if cell.trace:
        common.warm_profiler(dev)

    common.open_window(cell.trace)
    setup_s = time.monotonic() - cell.t_start
    t0 = hook.t0 = time.monotonic()
    state, history = trainer.run(state, steps=1 << 40)
    peak = common.peak_bytes(dev)
    t1 = time.monotonic()
    common.finish_profile(profile)
    spans = common.close_window(cell.trace)
    window_skipped = sum(h["skipped"] for h in history)
    trainer = state = data = None
    common.release(dev)

    steps = len(history)
    ctx = common.Ctx(kind="train", gan=gan, setup_s=setup_s, window_s=t1 - t0,
                     peak_bytes=peak, attempted=steps, failed=window_skipped,
                     batch=batch, steps=steps, samples=steps * batch, spans=spans,
                     profile=profile, profiled=hook.profiled_steps)
    numbers = compare(cfg, cell.seed, dev,
                      {"losses": losses, "m1": m1, "params": params, "skipped": skipped})
    return common.Outcome(
        ctx=ctx, numbers=numbers,
        busy_s=profile.busy_s() if profile is not None and profile.t1 else None,
        breakdown=common.breakdown(profile, common.host_intervals(spans, [])),
        diagnostics={"check_losses": losses, "window_steps": steps,
                     "profile_start_ms": 1e3 * profile.start_s if profile else 0.0})


def reference_run(cfg: dict, seed: int, device, **kw) -> dict:
    """The reference's checked steps, on the batches ``CHECK_BATCHES``,
    from the benchmark's weights and the configuration's synthetic
    inputs."""
    gan = work.Gan(cfg)
    batch = cfg["train"]["global_batch"]
    gp, dp = inputs.weights(cfg, seed, device, discriminator=True)
    tf32 = kw.get("tf32", False)

    def feed(t):
        b = CHECK_BATCHES[t]
        return (ref.images(seed, b, batch, gan.out_hw, gan.out_c, device, tf32=tf32),
                ref.latents(z_seed(seed), b, batch, gan.z_dim, device))

    return ref.train(gp, dp, cfg, feed, len(CHECK_BATCHES), **kw)


def compare(cfg: dict, seed: int, device, got: dict, want: dict | None = None) -> dict:
    """The numbers a training cell compares, of ``got`` (the program's
    checked steps: ``losses``, first moments after step one ``m1``,
    ``params`` after the last) against the reference's (``want``, run here
    when not given):

    * ``loss_gap``: the widest relative gap of a step's loss (infinite
      where the program ran another number of steps);
    * ``grad_gap``: by the worst leaf, the gap between the norms of the
      first gradient as the optimizer got it (its first moment over
      ``1 - b1``), over the reference's norm of that leaf or of the median
      leaf, whichever is larger;
    * ``change_gap``: likewise of the parameters' change over the checked
      steps, leaving out leaves whose reference gradient is under a
      thousandth of the median leaf's;
    * ``skipped_steps``: checked steps the program's guard skipped."""
    if want is None:
        want = reference_run(cfg, seed, device)
    g0, d0 = inputs.weights(cfg, seed, device, discriminator=True)
    p0 = {**{f"g.{k}": v for k, v in common.flatten(g0).items()},
          **{f"d.{k}": v for k, v in common.flatten(d0).items()}}

    loss_gap = max(rel_to(a, b, abs(b)) for pa, pb in zip(got["losses"], want["losses"])
                   for a, b in zip(pa, pb))
    if len(got["losses"]) != len(want["losses"]):
        loss_gap = float("inf")
    gnorm = {k: float(v.norm()) for k, v in want["m1"].items()}
    g_med = statistics.median(gnorm.values())
    grad_gap = max(rel_to(float(got["m1"][k].to(device).norm()), gnorm[k], max(gnorm[k], g_med))
                   for k in gnorm)
    moved = [k for k in gnorm if gnorm[k] >= 1e-3 * g_med]
    dref = {k: float((want["params"][k] - p0[k]).norm()) for k in moved}
    d_med = statistics.median(dref.values())
    change_gap = max(rel_to(float((got["params"][k].to(device) - p0[k]).norm()), dref[k],
                            max(dref[k], d_med)) for k in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "skipped_steps": got["skipped"]}


def rel_to(a: float, b: float, scale: float) -> float:
    d = abs(a - b) / scale if scale else abs(a - b)
    return d if d == d else float("inf")
