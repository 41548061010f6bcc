"""The Mamba, xLSTM and Whisper families placed over a mesh, on a real
four-rank world: a ``(data 2, model 2)`` mesh of four gloo processes on the
CPU, against the reference's unsharded programs.

A module fixture draws the reference's weights, batches and requests
(numpy), spawns the world once (``tests/torch_placement_families_worker.py``,
one process a rank, with a timeout of its own) and hands back every rank's
results; the reference's side is computed here. The configs, reduced and
fp32: Jamba, one period under ``fsdp`` with capacity for every token;
xLSTM; Whisper (serving in Megatron's mode, training in ZeRO-3's); and a
Whisper of 3 heads, which the 2-way ``model`` does not divide while its
columns divide, trained in Megatron's mode. For each, against the reference
within ``1e-5 max|ref| + 1e-6``: the prefill's logits and decode steps over
a placed cache holding its states, ``loss`` and its gradients, three train
steps, and the tokens the placed engine serves through a recycled slot;
every rank's local shard shapes of the parameters, moments and cache
against the reference's specs. Also: each mixer block's forward
collectives, the slot zeroing of a placed cache, the placed checkpoint's
round trip (Jamba), and the regroup's exchange plan on one process.
"""
import dataclasses
import os
import socket
import subprocess
import sys
import time

import jax

jax.devices()   # the backend is up before the reference's dry-run module loads
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry  # noqa: E402

if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import torch_placement_families_worker as W  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.data import SyntheticTokens as JSyntheticTokens  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models.lm import build_model as jbuild_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.distributed.collectives import _regroup_plan  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORLD = 4
SPAWN_TIMEOUT_S = 300
REL, ABS = 1e-5, 1e-6          # fp32: max |port - ref| <= REL * max|ref| + ABS
# Adam's eps: Jamba's Mamba layers hold many gradients near 1e-6 whose two
# correct fp32 sums differ; at 1e-6 an update moves with slope lr / eps
# there (tests/test_torch_lm_families_train.py takes 1e-4 for Jamba alike)
EPS = {"jamba": 1e-4, "xlstm": 1e-6, "whisper": 1e-6, "whisper3": 1e-6}
NAMES = list(W.configs())
REQUESTS = ((5, 4), (7, 5), (6, 3))   # (prompt length, new tokens): the third recycles slot 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jcfg(name):
    arch, kw = W.configs()[name]
    cfg = dataclasses.replace(jreduced(jget_config(arch)), dtype="float32", **kw)
    if cfg.moe.n_experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _frames(cfg, rng, b):
    return rng.normal(size=(b, cfg.n_frames, cfg.d_model)).astype(np.float32)


def _with_frames(cfg, batch, rng, b):
    if cfg.encoder_layers:
        batch["frames"] = _frames(cfg, rng, b)
    return batch


def _loss_batch(cfg, seed):
    """Uniform tokens and targets, the first three targets masked."""
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab_size, (W.TRAIN_BATCH, W.TRAIN_SEQ)).astype(np.int64)
           for k in ("tokens", "targets")}
    out["targets"][0, :3] = -1
    return _with_frames(cfg, out, rng, W.TRAIN_BATCH)


def _train_batch(cfg, step):
    """The reference's synthetic token batch of ``step`` (and seeded frames)."""
    out = {k: np.array(v, np.int64) for k, v in
           JSyntheticTokens(cfg.vocab_size, W.TRAIN_SEQ, W.TRAIN_BATCH).batch(step).items()}
    return _with_frames(cfg, out, np.random.default_rng(50 + step), W.TRAIN_BATCH)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``(inputs, [every rank's results])`` from one spawn of the world."""
    out = tmp_path_factory.mktemp("placed_families")
    rng = np.random.default_rng(11)
    inputs = {"requests": [(rng.integers(0, 256, n).tolist(), k) for n, k in REQUESTS]}
    for seed, name in enumerate(NAMES):
        cfg = _jcfg(name)
        jp = jbuild_model(cfg).init(jax.random.key(20 + seed))
        prompt = {"tokens": rng.integers(0, cfg.vocab_size, (W.SERVE_BATCH, W.PROMPT))}
        inputs[name] = {
            "params": _np(jp), "eps": EPS[name], "loss_batch": _loss_batch(cfg, 100 + seed),
            "batches": [_train_batch(cfg, i) for i in range(W.TRAIN_STEPS)],
            "prompt": _with_frames(cfg, prompt, rng, W.SERVE_BATCH),
            "decode_tokens": rng.integers(0, cfg.vocab_size,
                                          (W.DECODE_STEPS, W.SERVE_BATCH, 1))}
    torch.save(inputs, out / "inputs.pt")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    worker = os.path.join(os.path.dirname(__file__), "torch_placement_families_worker.py")
    logs = [open(out / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, worker, str(r), str(WORLD), str(port),
                               str(out)], env=env, cwd=ROOT, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(WORLD)]
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the {WORLD}-rank world did not finish in {SPAWN_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    failed = {}
    for r, p in enumerate(procs):
        if p.returncode != 0:
            err = out / f"rank{r}.err"
            failed[r] = (err if err.exists() else out / f"rank{r}.log").read_text()[-3000:]
    if failed:
        pytest.fail(f"ranks failed: {failed}")
    return inputs, [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _close(got, want, rel=REL, abs_=ABS, what=""):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, tol = np.abs(got - want).max(), rel * np.abs(want).max() + abs_
    assert err <= tol, (what, err, tol)


def _j(batch):
    return {k: jnp.asarray(v, jnp.float32 if v.dtype.kind == "f" else jnp.int32)
            for k, v in batch.items()}


def _params(name, inputs):
    return jax.tree_util.tree_map(jnp.asarray, inputs[name]["params"])


# ------------------------------------------------------------- serving (tp)

def _ref_serve(name, inputs):
    """The reference's unsharded prefill, then its decode steps over a
    cache holding the prefill's states; the cache after them."""
    jm = jbuild_model(_jcfg(name))
    jp = _params(name, inputs)
    logits, pre = jm.prefill(jp, _j(inputs[name]["prompt"]))
    cache = jax.tree_util.tree_map(
        lambda c, p: p if c.shape == p.shape else c.at[:, :, :p.shape[2]].set(p),
        jm.init_cache(W.SERVE_BATCH, W.MAX_LEN), pre)
    steps = []
    for i in range(W.DECODE_STEPS):
        batch = {"tokens": jnp.asarray(inputs[name]["decode_tokens"][i], jnp.int32),
                 "pos": jnp.full((W.SERVE_BATCH,), W.PROMPT + i, jnp.int32)}
        lg, cache = jm.decode_step(jp, cache, batch)
        steps.append(np.asarray(lg))
    return np.asarray(logits), steps, jax.tree_util.tree_leaves(cache)


@pytest.mark.parametrize("name", NAMES)
def test_placed_prefill_and_decode_match_the_reference(world, name):
    """The prefill's last logits, then decode steps over a placed cache
    holding the prefill's states (the attention caches' sequence over
    ``model``), on every rank, and the cache after them, against the
    reference's unsharded steps."""
    inputs, ranks = world
    want_prefill, want_steps, want_cache = _ref_serve(name, inputs)
    for r, res in enumerate(ranks):
        _close(res[f"{name}_prefill"], want_prefill, what=("prefill", r))
        for i, (got, want) in enumerate(zip(res[f"{name}_decode"], want_steps)):
            _close(got, want, what=("decode", r, i))
        assert len(res[f"{name}_decode_cache"]) == len(want_cache)
        for i, (got, want) in enumerate(zip(res[f"{name}_decode_cache"], want_cache)):
            _close(got, want, what=("cache", r, i))


def _ref_tokens(name, inputs) -> list:
    """Each request served alone by the reference's engine (its slot fresh:
    the reference zeroes no state when it recycles a slot, the port does)."""
    jm = jbuild_model(_jcfg(name))
    jp = _params(name, inputs)
    decode, out = None, []
    for prompt, k in inputs["requests"]:
        eng = JServeEngine(jm, jp, slots=W.ENGINE_SLOTS, max_len=W.ENGINE_MAX_LEN)
        decode = decode or eng._decode   # one compiled step for every engine
        eng._decode = decode
        req = JRequest(prompt=list(prompt), max_new_tokens=k)
        eng.run([req])
        out.append([int(t) for t in req.output])
    return out


@pytest.mark.parametrize("name", NAMES)
def test_recycled_slot_tokens_match_the_reference(world, name):
    """Three requests through the placed engine's two slots, the third in
    the slot the first left: every request's greedy tokens are the
    reference's for it alone."""
    inputs, ranks = world
    want = _ref_tokens(name, inputs)
    for r, res in enumerate(ranks):
        assert res[f"{name}_served"] == want, (r, res[f"{name}_served"], want)


@pytest.mark.parametrize("name", ["jamba", "xlstm"])
def test_slot_zeroing_touches_only_the_owning_ranks_row(world, name):
    """Admitting slot 1 zeroes its row of every recurrent state on the rank
    that holds it, and nothing else: each rank's leaves (slots over
    ``data``, or over ``model`` where the reference's cache rule puts
    them) hold zeros exactly in the slot-1 row if they hold it."""
    _, ranks = world
    for r, res in enumerate(ranks):
        for held, zeroed, n_zero in res[f"{name}_zeroing"]:
            assert zeroed == ([1] if 1 in held else []), (r, held, zeroed)
            if not zeroed:
                assert n_zero == 0


# ----------------------------------------------------------- training

def _ref_loss_and_grads(name, inputs):
    jm = jbuild_model(_jcfg(name))
    (loss, met), grads = jax.value_and_grad(jm.loss, has_aux=True)(
        _params(name, inputs), _j(inputs[name]["loss_batch"]))
    return float(loss), met, jax.tree_util.tree_leaves(grads)


@pytest.mark.parametrize("name", NAMES)
def test_placed_loss_and_grads_match_the_reference(world, name):
    inputs, ranks = world
    loss, met, grads = _ref_loss_and_grads(name, inputs)
    mode = W.port_config(name).train_parallelism
    for r, res in enumerate(ranks):
        assert res[f"{name}_mode"] == mode
        got_loss, got_ce, got_aux = res[f"{name}_loss"]
        assert abs(got_loss - loss) <= 1e-5 and abs(got_ce - float(met["ce"])) <= 1e-5
        assert abs(got_aux - float(met["aux"])) <= 1e-5
        assert len(res[f"{name}_grads"]) == len(grads)
        for i, (g, w) in enumerate(zip(res[f"{name}_grads"], grads)):
            _close(g, w, what=(name, r, i))


@pytest.mark.parametrize("name", NAMES)
def test_three_placed_train_steps_match_the_reference(world, name):
    """Three steps from one placed state on the same batches: the metrics
    within 1e-5; params within 1e-5, as the unplaced parity tests hold
    theirs (Adam moves a weight by about lr whatever its gradient's size:
    the port's unplaced xLSTM steps already part from the reference's by
    2.7e-6 here); the first moments within ``1e-5 max|ref| + 1e-6`` of
    each leaf and the second within ``2e-5 max|ref| + 1e-6`` (squares).
    The absolute term carries the moments of near-zero gradients: in
    Jamba's Mamba layers the port's unplaced steps already part from the
    reference's by 6e-5 of a first moment's largest at this size, where
    two correct fp32 sums of a gradient differ."""
    inputs, ranks = world
    jm = jbuild_model(_jcfg(name))
    jtc = jts.TrainConfig(optimizer=jadamw.AdamWConfig(lr=1e-3, eps=EPS[name]),
                          warmup_steps=2, total_steps=30)
    jp = _params(name, inputs)
    jo = jadamw.adamw_init(jp, jtc.optimizer)
    jstep = jax.jit(jts.make_train_step(jm, jtc))
    jmets = []
    for i in range(W.TRAIN_STEPS):
        jp, jo, jmet = jstep(jp, jo, _j(inputs[name]["batches"][i]))
        jmets.append({k: float(v) for k, v in jmet.items()})
    for r, res in enumerate(ranks):
        for got, want in zip(res[f"{name}_metrics"], jmets):
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                           err_msg=(name, r, k))
        for got, want in zip(res[f"{name}_params"], jax.tree_util.tree_leaves(jp)):
            _close(got, want, rel=0.0, abs_=1e-5, what=(name, r, "param"))
        for key, rel in (("m", REL), ("v", 2 * REL)):
            for got, want in zip(res[f"{name}_{key}"], jax.tree_util.tree_leaves(jo[key])):
                _close(got, want, rel=rel, what=(name, r, key))


def test_placed_checkpoint_round_trip_is_bitwise(world):
    """Rank 0 writes Jamba's gathered state (ZeRO-3 over ``data`` under
    Megatron's split) in the unplaced file format; every rank restores it,
    places it again with the same placements and bits, and a step from it
    equals a step from the live state bitwise."""
    _, ranks = world
    for res in ranks:
        assert res["jamba_ckpt"] == {"step": 5, "placed_again": True, "resume_bitwise": True}


# ------------------------------------------------------- shard shapes

def _shard(shape, spec):
    sizes = {"data": W.MESH[0], "model": W.MESH[1]}
    out = []
    for i, n in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        axes = e if isinstance(e, tuple) else ((e,) if e else ())
        out.append(n // int(np.prod([sizes[a] for a in axes])))
    return tuple(out)


def _under_mesh(fn, mode):
    jmesh = jsh.abstract_mesh(W.MESH, ("data", "model"))
    prev = jax.sharding.get_abstract_mesh
    jax.sharding.get_abstract_mesh = lambda: jmesh
    jsh.set_parallelism(mode)
    try:
        return fn()
    finally:
        jax.sharding.get_abstract_mesh = prev
        jsh.set_parallelism("tp")


def _leaf_shards(tree, specs):
    is_spec = lambda s: isinstance(s, jax.sharding.PartitionSpec)  # noqa: E731
    return [_shard(leaf.shape, spec) for leaf, spec in zip(
        jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(specs, is_leaf=is_spec))]


def _ref_param_shards(name, mode):
    jm = jbuild_model(_jcfg(name))
    jp = jm.abstract_params()
    return _leaf_shards(jp, _under_mesh(lambda: jsh.param_specs(jp, _jcfg(name).fsdp), mode))


def _ref_cache_shards(name):
    cfg = _jcfg(name)
    jc = jbuild_model(cfg).init_cache(W.SERVE_BATCH, W.MAX_LEN, abstract=True)
    shape = type("S", (), {"global_batch": W.SERVE_BATCH})
    return _leaf_shards(jc, _under_mesh(lambda: jdry.cache_specs(cfg, jc, shape), "tp"))


@pytest.mark.parametrize("name", NAMES)
def test_local_shard_shapes_are_the_references(world, name):
    """Every rank's local shard shapes against the reference's specs on the
    same mesh: the parameters in the serving mode and in the training mode,
    the moments beside them, and the decode cache."""
    _, ranks = world
    serve = _ref_param_shards(name, W.port_config(name).parallelism)
    train = _ref_param_shards(name, W.port_config(name).train_parallelism)
    cache = _ref_cache_shards(name)
    for res in ranks:
        assert [tuple(s) for s in res[f"{name}_local_shapes"]] == serve
        assert [tuple(s) for s in res[f"{name}_train_shapes"]] == train
        assert [tuple(s) for s in res[f"{name}_moment_shapes"]] == train + train
        assert [tuple(s) for s in res[f"{name}_cache_shapes"]] == cache


# ------------------------------------------------------- collectives

def _kinds(counts):   # DTensor's functional collectives and c10d's, by kind
    names = {"all_reduce": "all-reduce", "allreduce_": "all-reduce",
             "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
             "all_gather_into_tensor": "all-gather", "_allgather_base_": "all-gather",
             "allgather_": "all-gather"}
    out = {}
    for name, n in counts.items():
        kind = names.get(name, name)
        out[kind] = out.get(kind, 0) + n
    return out


@pytest.mark.parametrize("tag, want", [
    ("mamba", {"all-to-all": 1, "all-reduce": 2}),
    ("mlstm", {"all-to-all": 2, "all-reduce": 1}),
    ("slstm", {"all-reduce": 1}),
    ("mlstm_whole_heads", {"all-gather": 2, "all-reduce": 1}),
    ("slstm_whole_heads", {"all-gather": 1, "all-reduce": 1}),
])
def test_block_forward_collectives(world, tag, want):
    """One placed block's forward on a Megatron split: the regroup of a
    fused column-parallel product is its only collective beyond the
    all-reduce a row-parallel projection (Mamba's ``w_in`` regrouped, its
    ``w_bcdt`` and ``w_out`` all-reduced; mLSTM's ``w_qkv`` and ``w_if``
    regrouped; sLSTM's ``w_in`` read head-major needs none). Where the
    heads do not divide ``model`` the products are gathered instead."""
    _, ranks = world
    for res in ranks:
        assert _kinds(res[f"counts_{tag}"]) == want


# ------------------------------------------------------- regroup's plan

@pytest.mark.parametrize("n, m", [(2, 2), (3, 2), (2, 16), (3, 16), (1, 4), (5, 4), (4, 2)])
def test_regroup_plan_hands_each_rank_its_channels_of_every_block(n, m):
    """The exchange, simulated for every rank of ``m``: a weight of ``n``
    column blocks of ``c = 2 m`` columns split contiguously; what each rank
    receives, in source order, is its ``c / m`` channels of each block in
    block order, and the split sizes agree between senders and
    receivers."""
    c = 2 * m
    cols = np.arange(n * c)
    w_local = n * c // m
    s = c // m
    plans = [_regroup_plan(n, m, r) for r in range(m)]
    for t in range(m):
        got = []
        for src, (order, sent, _) in enumerate(plans):
            local = cols[src * w_local:(src + 1) * w_local].reshape(n, s)[order]
            start = sum(sent[:t])
            got.extend(local[start:start + sent[t]].tolist())
        want = [list(range(j * c + t * s, j * c + (t + 1) * s)) for j in range(n)]
        assert got == want, (t, got, want)
        assert plans[t][2] == [plans[src][1][t] for src in range(m)]
