"""The energy objective's training driver: the program's ``GanTrainer``
with ``objective="energy"`` (EB-GAN: an auto-encoder discriminator, the
margin's hinge and the pulling-away term) at the configuration's batch, fed
the program's ``SyntheticImages`` and its seeded latents.

It runs as ``drivers/train.py`` does: set-up draws the weights
(``inputs_energy.py``), builds the trainer and its state, and drives that
same object through ``GanTrainer.run``, once for one step (which captures
the step's CUDA graph; the first moments are read after it) and then for
three steps, which start again at step 0: the four checked steps, on the
feed's batches 0, 0, 1 and 2, which the reference
(``reference/ebgan.py``) follows. The window is ``GanTrainer.run`` on the
same trainer and state until ``--seconds`` have passed, stopped by the
SIGTERM the trainer stops on. The rate counts every sample of every step
the window ran over the window's wall.

The diagnostics carry the energy objective's four read-back values
(``energy_real``, ``energy_fake``, ``margin_active``, ``pt``) of each
checked step, the reference's of the same steps, and their mean and last
value over the window.
"""
from __future__ import annotations

import statistics
import time

import torch

from portbench import devtrace, inputs_energy, work_energy
from portbench.drivers import common
from portbench.drivers import train as classifier
from portbench.reference import ebgan as ref

CHECK_BATCHES = classifier.CHECK_BATCHES


def gan_config(cfg: dict):
    """The program's generator configuration, with its RGB head."""
    from repro_torch.models.gan import GANConfig

    return GANConfig(cfg["name"], cfg["z_dim"], tuple(tuple(row) for row in cfg["layers"]),
                     kernel=cfg["kernel"], padding=cfg["padding"], head=cfg["rgb_head"])


def trainer_config(cfg: dict, seed: int):
    """The program's trainer configuration: the energy objective with the
    configuration's margin, pulling-away weight and Adam (the program
    derives the auto-encoder's widths from the generator's)."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.gan_trainer import GanTrainerConfig

    o = cfg["train"]["optimizer"]
    opt = AdamWConfig(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                      weight_decay=o["weight_decay"],
                      clip_norm=float("inf") if o["clip_norm"] is None else o["clip_norm"])
    return GanTrainerConfig(global_batch=cfg["train"]["global_batch"], opt=opt,
                            ckpt_every=1 << 30, log_every=1 << 30,
                            z_seed=classifier.z_seed(seed), objective="energy",
                            margin=cfg["margin"], pt_weight=cfg["pt_weight"])


def _stats(rows: list, names) -> list:
    return [[h[k] for k in names] for h in rows]


def run(cell) -> common.Outcome:
    # the program's energy objective first: a program without it fails here
    gcfg, tcfg = gan_config(cell.cfg), trainer_config(cell.cfg, cell.seed)
    from repro_torch.data.pipeline import SyntheticImages
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.gan_trainer import ENERGY_STATS, GanTrainer

    dev = torch.device(cell.device)
    cfg, mix = cell.cfg, cell.mix
    gan = work_energy.EnergyGan(cfg)
    batch = tcfg.global_batch
    data = SyntheticImages(gan.out_hw, gan.out_c, batch, seed=cell.seed, device=dev)
    profile = devtrace.Profile() if cell.trace else None
    hook = classifier._Hook(cell.seconds, profile, mix["profile_from"])
    trainer = GanTrainer(gcfg, tcfg, data, device=dev, hooks=hook, log_fn=lambda *a: None)
    gp, dp = inputs_energy.weights(cfg, cell.seed, dev)
    state = {"g_params": gp, "d_params": dp, "g_opt": adamw_init(gp, tcfg.opt),
             "d_opt": adamw_init(dp, tcfg.opt)}
    gp = dp = None

    state, history = trainer.run(state, steps=1)
    m1 = {**{f"g.{k}": v.cpu() for k, v in common.flatten(state["g_opt"]["m"]).items()},
          **{f"d.{k}": v.cpu() for k, v in common.flatten(state["d_opt"]["m"]).items()}}
    state, more = trainer.run(state, steps=len(CHECK_BATCHES) - 1)
    history += more
    losses = [(h["g_loss"], h["d_loss"]) for h in history]
    checked = _stats(history, ENERGY_STATS)
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
    window = _stats(history, ENERGY_STATS)
    trainer = state = data = None
    common.release(dev)

    steps = len(history)
    ctx = common.Ctx(kind="train", gan=gan, setup_s=setup_s, window_s=t1 - t0,
                     peak_bytes=peak, attempted=steps, failed=window_skipped,
                     batch=batch, steps=steps, samples=steps * batch, spans=spans,
                     profile=profile, profiled=hook.profiled_steps)
    want = reference_run(cfg, cell.seed, dev)
    gaps = compare(cfg, cell.seed, dev,
                   {"losses": losses, "m1": m1, "params": params, "skipped": skipped}, want)
    return common.Outcome(
        ctx=ctx, numbers=gaps,
        busy_s=profile.busy_s() if profile is not None and profile.t1 else None,
        breakdown=common.breakdown(profile, common.host_intervals(spans, [])),
        diagnostics={"check_losses": losses, "stats_names": list(ENERGY_STATS),
                     "check_stats": checked, "reference_stats": want["stats"],
                     "window_stats_mean": [statistics.fmean(v) for v in zip(*window)],
                     "window_stats_last": window[-1] if window else [],
                     "window_steps": steps,
                     "profile_start_ms": 1e3 * profile.start_s if profile else 0.0})


def reference_run(cfg: dict, seed: int, device, **kw) -> dict:
    """The reference's checked steps, on the batches ``CHECK_BATCHES``,
    from the benchmark's weights and the configuration's synthetic
    inputs."""
    gan = work_energy.EnergyGan(cfg)
    batch = cfg["train"]["global_batch"]
    gp, dp = inputs_energy.weights(cfg, seed, device)
    tf32 = kw.get("tf32", False)

    def feed(t):
        b = CHECK_BATCHES[t]
        return (ref.images(seed, b, batch, gan.out_hw, gan.out_c, device, tf32=tf32),
                ref.latents(classifier.z_seed(seed), b, batch, gan.z_dim, device))

    return ref.train(gp, dp, cfg, feed, len(CHECK_BATCHES), **kw)


def compare(cfg: dict, seed: int, device, got: dict, want: dict) -> dict:
    """The gaps of ``got`` (the program's checked steps) from the
    reference's ``want``, as ``drivers/train.py``'s ``compare`` defines
    them: ``loss_gap`` (both losses of each step),
    ``grad_gap`` (the first gradient's norm, by the worst leaf),
    ``change_gap`` (the parameters' change over the checked steps, by the
    worst leaf) and ``skipped_steps``."""
    g0, d0 = inputs_energy.weights(cfg, seed, device)
    p0 = {**{f"g.{k}": v for k, v in common.flatten(g0).items()},
          **{f"d.{k}": v for k, v in common.flatten(d0).items()}}
    rel_to = classifier.rel_to
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
