"""End-to-end example of the PyTorch + CUDA port: train a (reduced) DC-GAN
whose generator runs on the unified kernel-segregated transpose
convolution, the paper's own workload. Mirrors ``examples/train_dcgan.py``.

Non-saturating GAN loss on synthetic band-limited images, AdamW for both
nets. The generator runs on a **compiled execution plan**
(:mod:`repro_torch.kernels.plan`): every layer's forward and backward
method is resolved once from the autotune cache (``train=True``: the
tuned full-step winners) before the step is built, and the step closes
over the plan. ``--tune`` races the reduced layer shapes first, so the
plan compiles against measured winners instead of the cold rule. On the
card the step (both updates) is one CUDA graph, the counterpart of the
reference's ``jax.jit``; on the CPU it runs eagerly through the kernels'
plain versions. Per-step wall time is logged by
:class:`repro_torch.timing.StepTimer`.

Run:  PYTHONPATH=src python examples/torch_train_dcgan.py [--steps 200] [--tune]
          [--device cpu]
"""
import argparse
import dataclasses

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--method", default="auto",
                    choices=["auto", "unified", "conventional", "pallas",
                             "pallas_phase"],
                    help="'auto' (default) follows the autotune cache's "
                         "training entries per layer shape (the cold rule "
                         "when the cache has none)")
    ap.add_argument("--tune", action="store_true",
                    help="race (fwd+bwd+step) the reduced layer shapes "
                         "before the plan is compiled")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.data import SyntheticImages
    from repro_torch.data.pipeline import step_generator
    from repro_torch.device import resolve_device
    from repro_torch.graphs import CudaGraph
    from repro_torch.models import gan
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    from repro_torch.timing import StepTimer
    from repro_torch.tree import tree_leaves, tree_map

    dev = resolve_device(args.device)
    # reduced DC-GAN (channels / 16): 32x32 outputs
    cfg = dataclasses.replace(
        gan.DCGAN,
        layers=tuple((hw, cin // 16, max(cout // 16, 3) if i == 3 else cout // 16)
                     for i, (hw, cin, cout) in enumerate(gan.DCGAN.layers[:3])),
    )
    out_hw = cfg.out_hw(cfg.layers[-1][0])
    out_c = cfg.layers[-1][2]
    print(f"[dcgan] generator -> {out_hw}x{out_hw}x{out_c}, method={args.method}, "
          f"on {dev}")

    if args.tune:
        # race before the plan is compiled: the plan pins what the cache
        # says when it is built
        from repro_torch.kernels import autotune

        for (hw, cin, cout), epi in zip(cfg.layers, gan.generator_epilogues(cfg)):
            rec = autotune.tune_layer(args.batch, hw, cfg.kernel, cin, cout,
                                      cfg.padding, train=True, epilogue=epi,
                                      device=dev)
            print(f"[tune] {hw}x{hw}x{cin}->{cout} [{epi.tag()}]: "
                  f"fwd={rec['fwd']['method']} bwd={rec['bwd']['method']} "
                  f"step={rec['step']['method']}")

    train_plan = gan.generator_plan(cfg, args.batch, train=True, method=args.method)
    print(train_plan.describe())
    gp = gan.generator_init(torch.Generator().manual_seed(0), cfg, device=dev)
    dp = gan.discriminator_init(torch.Generator().manual_seed(1), out_hw, out_c,
                                device=dev)
    opt_cfg = AdamWConfig(lr=2e-4, b1=0.5, b2=0.999, weight_decay=0.0)
    state = {"gp": gp, "dp": dp, "g_opt": adamw_init(gp, opt_cfg),
             "d_opt": adamw_init(dp, opt_cfg)}
    data = SyntheticImages(hw=out_hw, channels=out_c, global_batch=args.batch,
                           device=dev)

    def softplus(x):
        return torch.logaddexp(x, torch.zeros_like(x))

    def grad_of(loss_fn, params):
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(True), params)
            loss = loss_fn(live)
            flat = iter(torch.autograd.grad(loss, tree_leaves(live)))
        return loss.detach(), tree_map(lambda _: next(flat), live)

    def generate(gp, z):
        return gan.generator_apply(gp, cfg, z, plan=train_plan, device=dev)

    @torch.no_grad()
    def step(state, real, z):
        gp, dp = state["gp"], state["dp"]
        fake = generate(gp, z)
        dl, dg = grad_of(lambda d: softplus(-gan.discriminator_apply(d, real)).mean()
                         + softplus(gan.discriminator_apply(d, fake)).mean(), dp)
        dp, d_opt, _ = adamw_update(dg, state["d_opt"], dp, opt_cfg, opt_cfg.lr)
        gl, gg = grad_of(lambda g: softplus(
            -gan.discriminator_apply(dp, generate(g, z))).mean(), gp)
        gp, g_opt, _ = adamw_update(gg, state["g_opt"], gp, opt_cfg, opt_cfg.lr)
        return {"gp": gp, "dp": dp, "g_opt": g_opt, "d_opt": d_opt}, torch.stack([gl, dl])

    graph = None
    timer = StepTimer()
    for i in range(args.steps):
        real = data.batch(i)
        z = torch.randn((args.batch, cfg.z_dim), device=dev,
                        generator=step_generator(7, i, dev))
        if dev.type == "cuda":   # one CUDA graph a step, captured at the first
            if graph is None:
                graph = CudaGraph(step, state, real, z)
            new, losses = graph(state, real, z)
            state = graph.inputs[0]
            torch._foreach_copy_(tree_leaves(state), tree_leaves(new))
        else:
            state, losses = step(state, real, z)
        gl, dl = losses.tolist()
        dt = timer.tick()
        if i % 20 == 0:
            print(f"step {i:4d}  g_loss {gl:.4f}  d_loss {dl:.4f}  step "
                  f"{dt * 1e3:.1f}ms  (mean {timer.mean() * 1e3:.1f}ms)")
    print(f"[dcgan] steady-state step time: mean {timer.mean() * 1e3:.2f}ms "
          f"median {timer.median() * 1e3:.2f}ms over {len(timer.steps)} steps")
    # eval plan: batch 1, inference-mode winners
    eval_plan = gan.generator_plan(cfg, 1, method=args.method)
    with torch.no_grad():
        img = gan.generator_apply(
            state["gp"], cfg,
            torch.randn((1, cfg.z_dim), device=dev, generator=step_generator(9, 0, dev)),
            plan=eval_plan, device=dev)
    finite = bool(torch.isfinite(img).all())
    print(f"[dcgan] done: sample range [{float(img.min()):.3f}, "
          f"{float(img.max()):.3f}], finite={finite}")
    if not finite:
        raise SystemExit("[dcgan] the trained generator's sample is not finite")
    return gl, dl


if __name__ == "__main__":
    main()
