"""EB-GAN as published (``models/gan.py::EBGAN_PUBLISHED`` and the energy
objective of ``train/gan_trainer.py``) against the benchmark's plain
reference ``portbench/reference/ebgan.py`` on the CPU, at a sixteenth of the widths with
seeded weights: the generator with its RGB head, the auto-encoder's
energy, both losses with the margin's hinge all live, all dead and mixed,
the pulling-away term, both nets' gradients, two ``GanTrainer.run`` steps
against the reference's Adam steps, and the backward's ``need_dw``."""
import itertools
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))   # the repo's root
from portbench.reference import ebgan as ref  # noqa: E402
from repro_torch.data import SyntheticImages
from repro_torch.data.pipeline import step_generator
from repro_torch.kernels import rgb_head as headlib
from repro_torch.kernels import transpose_conv2d_bwd as bw
from repro_torch.kernels.epilogue import Epilogue
from repro_torch.models import gan
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.gan_trainer import ENERGY_STATS, GanTrainer, GanTrainerConfig
from repro_torch.tree import tree_leaves, tree_map

CFG = gan.reduced_config(gan.EBGAN_PUBLISHED)
WIDTHS = gan.autoencoder_widths(CFG)
HW, C = CFG.image_hw, CFG.image_channels
DCFG = gan.decoder_config(HW, C, WIDTHS)
OPT = {"lr": 2e-4, "b1": 0.5, "b2": 0.999, "eps": 1e-8, "weight_decay": 0.0,
       "clip_norm": None}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the suite runs several workers on the
    machine's cores, and these tests' 256x256 maps ran some 20 times
    slower where every worker's ops spread over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_cfg(margin: float) -> dict:
    return {"layers": [list(row) for row in CFG.layers], "padding": CFG.padding,
            "margin": margin, "pt_weight": 0.1, "train": {"optimizer": OPT}}


def _params(seed: int = 0) -> tuple:
    """Seeded generator and auto-encoder weights, every bias drawn nonzero
    so that the bias paths carry signal."""
    g = torch.Generator().manual_seed(seed)
    gp = gan.generator_init(g, CFG, device="cpu")
    dp = gan.autoencoder_init(g, HW, C, WIDTHS, device="cpu")
    for path, leaf in _named(gp) + _named(dp):
        if path.endswith(".b"):
            leaf.copy_(0.05 * torch.randn(leaf.shape, generator=g))
    return gp, dp


def _named(tree: dict, prefix: str = "") -> list:
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _named(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)]
    return out


def _inputs(batch: int = 3, seed: int = 1) -> tuple:
    g = torch.Generator().manual_seed(seed)
    real = torch.tanh(torch.randn((batch, HW, HW, C), generator=g))
    return real, torch.randn((batch, CFG.z_dim), generator=g)


def _close(got, want, tol=2e-5):
    scale = want.abs().max().item() if torch.is_tensor(want) else abs(want)
    err = (got - want).abs().max().item() if torch.is_tensor(want) else abs(got - want)
    assert err <= tol * max(scale, 1e-30), (err, scale)


def _trainer(margin: float, batch: int = 3) -> GanTrainer:
    data = SyntheticImages(HW, C, batch, seed=5, device="cpu")
    opt = AdamWConfig(lr=OPT["lr"], b1=OPT["b1"], b2=OPT["b2"], eps=OPT["eps"],
                      weight_decay=0.0)
    tcfg = GanTrainerConfig(global_batch=batch, opt=opt, z_seed=9, objective="energy",
                            margin=margin, pt_weight=0.1,
                            ckpt_every=1 << 30, log_every=1 << 30)
    return GanTrainer(CFG, tcfg, data, device="cpu", log_fn=lambda *a: None)


def test_generator_with_its_rgb_head_matches_the_reference():
    gp, _ = _params()
    _, z = _inputs()
    plan = gan.generator_plan(CFG, 3, train=True)
    got = gan.generator_apply(gp, CFG, z, plan=plan, device="cpu")
    want = ref.generator(gp, _ref_cfg(1.0), z)
    assert got.shape == want.shape == (3, HW, HW, 3)
    _close(got, want)
    # every transpose conv takes relu; the head makes the image
    assert [e.act for e in gan.generator_epilogues(CFG)] == ["relu"] * len(CFG.layers)
    # the CPU head is one call a sample: a row's bits do not depend on the batch
    x = torch.randn((4, 8, 8, 5))
    w, b = torch.randn((5, 3)), torch.randn(3)
    full = headlib.head_rows(x, w, b)
    assert all(torch.equal(headlib.head_rows(x[i:i + 1], w, b)[0], full[i]) for i in range(4))


def test_energy_and_code_match_the_reference():
    _, dp = _params()
    real, _ = _inputs()
    e, code = gan.energy(dp, DCFG, real, plan=gan.generator_plan(DCFG, 3, train=True))
    e_ref, s_ref = ref.energy(dp, _ref_cfg(1.0), real)
    assert e.shape == (3,) and code.shape == (3, HW >> 4, HW >> 4, WIDTHS[-1])
    _close(e, e_ref)
    _close(code.reshape(3, -1), s_ref)
    assert [lay for lay in DCFG.layers] == [(16, 32, 16), (32, 16, 8), (64, 8, 4), (128, 4, 3)]


def test_pulling_away_term_is_the_mean_squared_cosine_of_distinct_pairs():
    s = torch.randn((5, 7, 2, 3), generator=torch.Generator().manual_seed(3))
    got = gan.pulling_away(s)
    rows = s.reshape(5, -1).double()
    want = sum((rows[i] @ rows[j] / (rows[i].norm() * rows[j].norm())) ** 2
               for i, j in itertools.permutations(range(5), 2)) / 20
    _close(got.double(), want, 1e-6)
    _close(got, ref.pulling_away(s.reshape(5, -1)), 1e-6)
    with pytest.raises(ValueError):
        gan.pulling_away(s[:1])


@pytest.mark.parametrize("hinge", ["live", "dead", "mixed"])
def test_losses_match_the_reference_with_the_hinge(hinge):
    """Both losses and the discriminator phase's read-back, with the margin
    above every fake energy (hinge live on all rows), below every one
    (dead) and between them (mixed)."""
    gp, dp = _params()
    real, z = _inputs()
    with torch.no_grad():
        fake = ref.generator(gp, _ref_cfg(1.0), z)
        e_fake, _ = ref.energy(dp, _ref_cfg(1.0), fake)
    lo, hi = e_fake.min().item(), e_fake.max().item()
    margin = {"live": 2 * hi, "dead": 0.5 * lo, "mixed": 0.5 * (lo + hi)}[hinge]
    tr = _trainer(margin)
    d_l, d_aux = tr._d_loss_energy(dp, gp, real, z)
    want, e_real, e_fake = ref.d_loss(dp, _ref_cfg(margin), real, fake)
    _close(d_l, want)
    share = {"live": 1.0, "dead": 0.0, "mixed": (e_fake < margin).float().mean().item()}[hinge]
    assert 0 < share < 1 or hinge != "mixed"
    _close(d_aux[:2], torch.stack([e_real.mean(), e_fake.mean()]))
    assert d_aux[2].item() == share
    g_l, g_aux = tr._g_loss_energy(gp, dp, z)
    want_g, pt = ref.g_loss(dp, _ref_cfg(margin), fake)
    _close(g_l, want_g)
    _close(g_aux[0], pt)


def _grads(fn, params):
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    out = fn(live)
    loss = out[0] if isinstance(out, tuple) else out
    return dict(zip([k for k, _ in _named(live)],
                    torch.autograd.grad(loss, [v for _, v in _named(live)])))


def test_both_nets_gradients_match_the_reference():
    """The discriminator's gradients (mixed hinge) and the generator's
    through the auto-encoder and the pulling-away term, leaf by leaf
    within 1e-4 of the leaf's largest reference entry."""
    gp, dp = _params()
    real, z = _inputs()
    with torch.no_grad():
        fake = ref.generator(gp, _ref_cfg(1.0), z)
        e_fake, _ = ref.energy(dp, _ref_cfg(1.0), fake)
    margin = e_fake.median().item() + 1e-3
    tr, rc = _trainer(margin), _ref_cfg(margin)
    pairs = [(_grads(lambda d: tr._d_loss_energy(d, gp, real, z), dp),
              _grads(lambda d: ref.d_loss(d, rc, real, fake), dp)),
             (_grads(lambda g: tr._g_loss_energy(g, dp, z), gp),
              _grads(lambda g: ref.g_loss(dp, rc, ref.generator(g, rc, z)), gp))]
    for got, want in pairs:
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k], 1e-4)


def test_two_trainer_steps_follow_the_reference_adam_steps():
    """Two steps of ``GanTrainer.run`` with the energy objective against
    the reference's steps on the same batches: losses, the four read-back
    values, and each parameter's change within 1e-3 of the reference's."""
    gp, dp = _params()
    tr = _trainer(margin=0.3, batch=2)
    state = tr.init_state(torch.Generator().manual_seed(0))
    state = dict(state, g_params=tree_map(torch.clone, gp), d_params=tree_map(torch.clone, dp))
    state, hist = tr.run(state, steps=2)

    def feed(t):
        return tr.data.batch(t), torch.randn((2, CFG.z_dim), generator=step_generator(9, t, "cpu"))

    want = ref.train(gp, dp, _ref_cfg(0.3), feed, 2)
    for row, (g_l, d_l), stats in zip(hist, want["losses"], want["stats"]):
        assert not row["skipped"]
        _close(row["g_loss"], g_l, 1e-4)
        _close(row["d_loss"], d_l, 1e-4)
        got = [row[k] for k in ENERGY_STATS]
        assert got[2] == stats[2]
        for a, b in zip(got, stats):
            _close(a, b, 1e-4)
    p0 = {f"g.{k}": v for k, v in _named(gp)} | {f"d.{k}": v for k, v in _named(dp)}
    after = ({f"g.{k}": v for k, v in _named(state["g_params"])}
             | {f"d.{k}": v for k, v in _named(state["d_params"])})
    for k, v in want["params"].items():
        moved = (v - p0[k]).norm().item()
        assert (after[k] - v).norm().item() <= 1e-3 * max(moved, 1e-12) + 1e-9, k


@pytest.mark.parametrize("epi", [None, Epilogue(bias=True, act="relu"),
                                 Epilogue(bias=True, act="tanh")], ids=["none", "relu", "tanh"])
def test_backward_without_dw_returns_dx_alone_bitwise(epi):
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 8, 8, 6), generator=g)
    k = torch.randn((4, 4, 6, 5), generator=g)
    y = torch.tanh(torch.randn((2, 16, 16, 5), generator=g))
    if epi is not None and epi.act == "relu":
        y = y.clamp(min=0)
    gy = torch.randn((2, 16, 16, 5), generator=g)
    dx, dw, db = bw.transpose_conv2d_bwd(x, k, gy, 2, epilogue=epi, y=y)
    dx2, dw2, db2 = bw.transpose_conv2d_bwd(x, k, gy, 2, epilogue=epi, y=y, need_dw=False)
    assert torch.equal(dx, dx2) and dw2 is None and db2 is None
    assert dw is not None and (db is not None) == (epi is not None)


@pytest.mark.parametrize("bwd", ["segregated", "autograd"])
def test_discriminator_phases_compute_dw_only_where_weights_need_it(monkeypatch, bwd):
    """The decoder's layers compute dW in the discriminator's phase and none
    in the generator's, where only the generator's layers take one, through
    either backward."""
    from repro_torch.kernels import ops

    calls = []
    if bwd == "segregated":
        orig = bw.transpose_conv2d_dw
        monkeypatch.setattr(bw, "transpose_conv2d_dw",
                            lambda *a, **k: calls.append(True) or orig(*a, **k))
    else:
        orig = ops._autograd_bwd
        monkeypatch.setattr(ops, "_autograd_bwd",
                            lambda *a: calls.append(a[-1]) or orig(*a))
    tr = _trainer(margin=0.3)
    tr.train_plan = gan.generator_plan(CFG, 3, train=True, bwd=bwd)
    tr.dec_plans = tuple(gan.generator_plan(DCFG, n, train=True, bwd=bwd) for n in (6, 3))
    gp, dp = _params()
    real, z = _inputs()
    _grads(lambda d: tr._d_loss_energy(d, gp, real, z), dp)
    d_calls = list(calls)
    calls.clear()
    _grads(lambda g: tr._g_loss_energy(g, dp, z), gp)
    # the decoder's dW in D's phase (no generator backward there); the
    # generator's in G's phase, the decoder's dx alone
    assert d_calls.count(True) == len(DCFG.layers)
    assert calls.count(True) == len(CFG.layers)
    if bwd == "autograd":
        assert calls.count(False) == len(DCFG.layers)


def test_energy_trainer_config_is_checked():
    with pytest.raises(ValueError, match="objective"):
        GanTrainerConfig(objective="wasserstein")
    with pytest.raises(ValueError, match="margin"):
        GanTrainerConfig(objective="energy")
    # the auto-encoder mirrors the generator, reduced with it
    assert gan.autoencoder_widths(gan.EBGAN_PUBLISHED) == (64, 128, 256, 512)
    assert WIDTHS == (4, 8, 16, 32)
    tr = _trainer(margin=0.3)
    assert tr.out_c == 3 and tr.out_hw == 256
    state = tr.init_state(torch.Generator().manual_seed(0))
    assert set(state["d_params"]) == {"enc0", "enc1", "enc2", "enc3", "dec"}
    assert len(tree_leaves(state["d_params"])) == 4 + 8


@pytest.mark.parametrize("pixels", [1, 127, 128, 129, 4096 * 16 + 5, 64 * 256 * 256])
def test_rgb_head_dw_split_covers_every_pixel_once(pixels):
    """dW's partial pass: at most DW_BLOCKS blocks of whole 128-pixel tiles
    that cover every pixel, and no block past the last tile."""
    blocks, tiles = headlib.dw_split(pixels)
    assert 1 <= blocks <= headlib.DW_BLOCKS
    assert blocks * tiles * headlib.PIXEL_TILE >= pixels
    assert (blocks - 1) * tiles * headlib.PIXEL_TILE < pixels


@pytest.fixture
def tracing():
    """An enabled tracer installed as the process global, the previous
    tracer and flag restored afterwards."""
    from repro_torch.obs import trace as obs

    tracer = obs.Tracer()
    prev, was = obs.set_tracer(tracer), obs.enabled()
    obs.enable()
    yield tracer
    obs.set_tracer(prev)
    (obs.enable if was else obs.disable)()


def test_energy_step_records_its_read_back_as_gauges(tracing):
    """With tracing on, each step sets the gauges ``train.<name>`` of the
    four read-back values to its history row's, inside the step's spans
    (the commit's), and adds no span of its own."""
    tr = _trainer(margin=0.3, batch=2)
    state = tr.init_state(torch.Generator().manual_seed(0))
    _, hist = tr.run(state, steps=2)
    assert {f"train.{k}": hist[-1][k] for k in ENERGY_STATS} == {
        k: v for k, v in tracing.gauges.items() if k.removeprefix("train.") in ENERGY_STATS}
    names = {s["name"] for s in tracing.spans}
    assert names <= {"train.step", "train.batch", "train.step_fn", "train.launch",
                     "train.readback", "train.commit", "host.gc", "host.gc.hook"}
