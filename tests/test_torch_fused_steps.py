"""The fused multi-step train launch (``dev.fuse_steps``) on the CPU,
held against the port's serial loop and the JAX package's fused launch
(``tests/test_fused_steps.py`` holds the JAX package's against its own
serial loop):

- the epoch's bookkeeping: the port's ``Trainer._run_epoch`` and the
  JAX package's ``Trainer._run_epoch_fused``, driven by the same
  recording steps, give the same (step index, LR, batch) sequence, the
  same launches, tail steps and step count; a per-step host hook without a chunk flush is refused (and
  the entry runtime falls back to the serial loop); ``post_chunk`` is
  flushed one chunk late and in step order, before the tail's
  ``post_step``s;
- numbers: PEMP stage 1 (one block a stage, 33x33, float64, cedt,
  k = 2 over 3 steps: one chunk and a serial tail) equals its serial
  epoch exactly (on the CPU a fused launch is the same eager steps), and
  the JAX package's fused epoch (``make_train_step_fused`` and the serial
  tail, on the same numpy inputs and weights) within 1e-7 of each leaf's
  largest magnitude, the tolerance of the f64 stage-1 step test
  (``tests/test_torch_train_parity.py``); CaNet's history store is byte
  for byte the serial loop's at every epoch boundary;
- the update at a tensor LR (``solver.step``) equals ``torch.optim.SGD``
  and ``torch.optim.Adam`` at the float LR bit for bit, momentum buffers
  included; a fused run's ``ckpt.pt`` equals the serial run's and resumes
  in a serial run;
- ``PEMP_PROFILE_DIR``: a trace of the second epoch only; unset, none.

Every test removes what it writes.
"""

import importlib
import json
import shutil
from types import SimpleNamespace
from unittest import mock

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from pemp_tpu.core import losses as jax_losses
from pemp_tpu.core import solver as jax_solver
from pemp_tpu.core import trainer as jax_trainer
from pemp_tpu.models import common as jax_common
from pemp_tpu.models.pemp_stage1 import PEMPStage1 as JaxPEMPStage1
from pemp_tpu.parallel import step as jax_step
from pemp_tpu.utils.timer import Timer as JaxTimer
from pemp_tpu_torch.config import Run
from pemp_tpu_torch.core import checkpoint as ckpt_lib
from pemp_tpu_torch.core import solver
from pemp_tpu_torch.core.trainer import GracefulStop, Trainer
from pemp_tpu_torch.entry import pemp_stage1
from pemp_tpu_torch.models.pemp_stage1 import PEMPStage1
from pemp_tpu_torch.utils.convert import state_dict_from_jax
from pemp_tpu_torch.utils.timer import Timer
from tests import torch_parallel_worker as worker
from tests.test_torch_parity_helpers import (  # noqa: F401
    assert_leaves_close, one_torch_thread, sd64, tree64,
)

SMALL = ["split=0", "data.dataset=SYNTH", "data.height=33", "data.width=33",
         "data.bs=2", "data.test_bs=2", "data.test_n=2", "te.epochs=1",
         "data.num_workers=1", "dev.device=cpu", "dev.precision=f32"]
H = W = 33
B, S, Q = 2, 1, 1
SIGMA = 5.0
REL = 1e-7
TR = {"tr.lr": "0.025", "tr.sgd_momentum": "0.9", "tr.weight_decay": "5e-4",
      "tr.grad_clip": "1.1", "tr.sgd_nesterov": "False"}


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed with what the test wrote into it."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


class PolyLike:
    """A per-step LR schedule with a distinct value each step."""

    def __init__(self, base=1.0):
        self.base = base
        self.lr = base
        self.steps = 0

    def step_step(self):
        self.steps += 1
        self.lr = self.base / (1.0 + self.steps)

    def state_dict(self):
        return {"steps": self.steps}


def port_trainer(fuse, runtime=None, model=None, lr_policy=None, cfg=None,
                 forward=None):
    """A port trainer on the CPU (a toy model unless ``model`` is given)."""
    if cfg is None:
        cfg = pemp_stage1.ex.assemble("train", dict(
            a.split("=", 1) for a in SMALL + ["dev.compact_wire=False"]))
    model = model or torch.nn.Linear(2, 2)
    params = [p for p in model.parameters() if p.requires_grad]
    runtime = runtime or SimpleNamespace(post_step=None, post_chunk=None,
                                         device_keys=("sup_rgb",))
    return Trainer(cfg, Run(None, None), model,
                   solver.make_optimizer(cfg.tr, params), params, runtime,
                   lr_policy or PolyLike(), torch.device("cpu"),
                   forward=forward, fuse_steps=fuse)


# --- bookkeeping --------------------------------------------------------------

def jax_sequence(n, k):
    """``pemp_tpu``'s fused epoch over ``n`` batches with recording steps:
    ((step index, LR, batch) of every step, launches, tail steps, n)."""
    cfg = SimpleNamespace(g=SimpleNamespace(model_dir="unused"), tag="t",
                          tr=SimpleNamespace(total_epochs=1, ckpt_epoch=0),
                          seed=1)
    trainer = jax_trainer.Trainer(cfg, SimpleNamespace(_id=None),
                                  state=SimpleNamespace(), train_step=None,
                                  lr_policy=PolyLike(), steps_per_epoch=0,
                                  logger_name="test")
    trainer.fuse_steps = k
    rng = jax.random.PRNGKey(3)
    seq, launches, tail = [], [], []

    def fused(state, chunk, lrs, rng_, first_idx):
        launches.append(first_idx)
        seq.extend((first_idx + j, lr, b)
                   for j, (lr, b) in enumerate(zip(lrs, chunk)))
        return state, np.zeros(len(chunk), np.float32)

    def serial(state, batch, lr, step_rng):
        idx = next(i for i in range(n) if np.array_equal(
            np.asarray(step_rng), np.asarray(jax.random.fold_in(rng, i))))
        tail.append(idx)
        seq.append((idx, lr, batch))
        return state, np.float32(0.0), {}

    trainer.train_step_fused, trainer.train_step = fused, serial
    got = trainer._run_epoch_fused([f"b{i}" for i in range(n)], rng, [],
                                   JaxTimer(), jax_trainer.GracefulStop(),
                                   world=1)
    return seq, len(launches), len(tail), got


def port_sequence(n, k):
    """The port's fused epoch over the same batches: the same record."""
    trainer = port_trainer(k)
    seq, launches, tail = [], [], []

    def fused(chunk, lrs):
        first = len(seq)
        launches.append(first)
        seq.extend((first + j, lr, b)
                   for j, (lr, b) in enumerate(zip(lrs, chunk)))
        return torch.zeros(len(chunk)), None

    def serial(batch):
        tail.append(len(seq))
        seq.append((len(seq), trainer.lr_policy.lr, batch))
        return torch.zeros(())

    trainer.train_step_fused, trainer.train_step = fused, serial
    losses = []
    got = trainer._run_epoch([f"b{i}" for i in range(n)], losses, Timer(),
                             GracefulStop(), world=1)
    assert len(losses) == len(launches) + len(tail)
    assert trainer.lr_policy.steps == n
    return seq, len(launches), len(tail), got


@pytest.mark.parametrize("n, k", [(7, 3), (6, 3), (2, 3)])
def test_epoch_bookkeeping_matches_the_jax_trainer(n, k):
    want = jax_sequence(n, k)
    got = port_sequence(n, k)
    assert got == want
    seq, launches, tail, steps = got
    assert (launches, tail, steps) == (n // k, n % k, n)
    assert [s[0] for s in seq] == list(range(n))
    assert [s[1] for s in seq] == pytest.approx(
        [1.0 / (1 + i) for i in range(n)])


def test_fused_warm_up_follows_a_ddp_forward():
    """A fused step warms up DDP's bucket rebuild (DDP_WARMUP_STEPS eager
    steps) whenever the forward is a DistributedDataParallel, a world of
    one included, and WARMUP_STEPS otherwise."""
    import socket

    import torch.distributed as dist

    from pemp_tpu_torch.parallel.step import DDP_WARMUP_STEPS, WARMUP_STEPS
    assert port_trainer(2).train_step_fused.warmup_steps == WARMUP_STEPS
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        model = torch.nn.Linear(2, 2)
        ddp = torch.nn.parallel.DistributedDataParallel(model)
        trainer = port_trainer(2, model=model, forward=ddp)
        assert trainer.train_step_fused.warmup_steps == DDP_WARMUP_STEPS
    finally:
        dist.destroy_process_group()


def test_fused_epoch_rejects_post_step_without_post_chunk(caplog):
    runtime = SimpleNamespace(post_step=lambda logits, batch: None,
                              post_chunk=None, device_keys=("sup_rgb",))
    trainer = port_trainer(2, runtime)
    with pytest.raises(RuntimeError, match="post_chunk"):
        trainer._run_epoch([1, 2], [], Timer(), GracefulStop(), 1)
    # the entry runtime trains such a family serially, and says so
    cfg = pemp_stage1.ex.assemble("train", dict(
        a.split("=", 1) for a in SMALL + ["dev.fuse_steps=3"]))
    rt = pemp_stage1.Stage1Runtime(cfg)
    assert rt.fuse_steps(torch.device("cpu")) == 3
    rt.post_step = runtime.post_step
    rt.logger.propagate = True
    try:
        with caplog.at_level("INFO"):
            assert rt.fuse_steps(torch.device("cpu")) == 1
    finally:
        rt.logger.propagate = False
    assert "dev.fuse_steps ignored" in caplog.text


@pytest.mark.parametrize("n", [8, 6])
def test_post_chunk_flushes_one_chunk_late_in_step_order(n):
    """k = 3: chunk i's flush follows chunk i+1's launch; a serial tail
    first flushes the pending chunk, then writes each step's logits; with
    no tail the last chunk is flushed at the epoch's end."""
    events = []
    runtime = SimpleNamespace(
        post_step=lambda logits, batch: events.append(
            ("step", int(logits), batch["i"])),
        post_chunk=lambda auxes, batches: events.append(
            ("chunk", auxes.tolist(), [b["i"] for b in batches])),
        device_keys=("sup_rgb",))
    trainer = port_trainer(3, runtime)

    def fused(chunk, lrs):
        events.append(("launch", [b["i"] for b in chunk]))
        return torch.zeros(len(chunk)), torch.tensor([b["i"] for b in chunk])

    def device_step(t, lr):
        return torch.zeros(()), t["sup_rgb"][0].long()

    trainer.train_step_fused, trainer.device_step = fused, device_step
    loader = [{"i": i, "sup_rgb": np.full((1,), i, np.float32)}
              for i in range(n)]
    assert trainer._run_epoch(loader, [], Timer(), GracefulStop(), 1) == n
    want = [("launch", [0, 1, 2]), ("launch", [3, 4, 5]),
            ("chunk", [0, 1, 2], [0, 1, 2]), ("chunk", [3, 4, 5], [3, 4, 5])]
    want += [("step", i, i) for i in range(6, n)]
    assert events == want


# --- stage 1 against the serial epoch and the JAX package ---------------------

@pytest.fixture(scope="module")
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def batches(n):
    """Host batches from numpy: float32-valued images (the JAX package's
    ``unpack_batch`` casts images to float32) held as float64, [fg, bg]
    masks, labels with an ignored corner."""
    rng = np.random.RandomState(5)
    out = []
    for i in range(n):
        fg = (rng.rand(B, S, H, W, 1) > 0.5).astype(np.float64)
        labels = rng.randint(0, 2, (B, Q, H, W)).astype(np.int64)
        labels[..., :4, :6] = 255
        out.append({
            "sup_rgb": rng.randn(B, S, H, W, 3).astype(np.float32)
            .astype(np.float64),
            "sup_mask": np.concatenate([fg, 1 - fg], -1),
            "qry_rgb": rng.randn(B, Q, H, W, 3).astype(np.float32)
            .astype(np.float64),
            "qry_msk": labels, "cls": np.full((B,), 1 + i, np.int64)})
    return out


def jax_trace(opt_state):
    """The momentum trace (``optax.trace``) inside the package's chain."""
    if isinstance(opt_state, optax.TraceState):
        return opt_state.trace
    if isinstance(opt_state, dict):
        parts = opt_state.values()
    elif isinstance(opt_state, tuple):
        parts = opt_state
    else:
        return None
    for part in parts:
        found = jax_trace(part)
        if found is not None:
            return found
    return None


@pytest.fixture(scope="module")
def jax_epoch(x64):
    """The JAX package's epoch of 3 steps at k = 2 (one fused launch, then
    the serial step): its initial variables (float32 values), losses and
    final params, statistics and momentum trace."""
    with mock.patch.dict(jax_common.RESNET_LAYERS, {"resnet50": (1, 1, 1)}):
        model = JaxPEMPStage1(backbone="resnet50", protos=3, drop_rate=0.0,
                              dtype=jnp.float64)
        variables = jax.jit(lambda k: model.init(
            {"params": k}, jnp.zeros((1, S, H, W, 3)),
            jnp.zeros((1, S, H, W, 2)), jnp.zeros((1, Q, H, W, 3))))(
            jax.random.PRNGKey(0))
        params = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                        variables["params"])
        stats = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                       variables["batch_stats"])

        def loss_fn(p, batch_stats, batch, rng):
            out, mutated = model.apply(
                {"params": p, "batch_stats": batch_stats}, batch["sup_rgb"],
                batch["sup_mask"], batch["qry_rgb"], out_hw=(H, W),
                train=True, rngs={"dropout": rng}, mutable=["batch_stats"])
            lg = out.reshape(B * Q, H, W, 2)
            labels = batch["qry_msk"].reshape(B * Q, H, W)
            return (jax_losses.cedt(lg, labels, SIGMA, use_pallas=False),
                    (mutated["batch_stats"], {}))

        tr = SimpleNamespace(opt="sgd", sgd_momentum=0.9, sgd_nesterov=False,
                             weight_decay=5e-4, grad_clip=1.1)
        p64 = tree64(params)
        tx = jax_solver.make_optimizer(tr, jax_solver.trainable_mask(
            p64, JaxPEMPStage1.FROZEN["resnet50"]))
        state = jax_trainer.TrainState(p64, tree64(stats), tx.init(p64))
        lrs = [0.025 / (1 + i) for i in range(3)]
        rng = jax.random.PRNGKey(7)
        data = batches(3)
        with jax.default_matmul_precision("highest"):
            fused = jax_step.make_train_step_fused(loss_fn, tx, 2,
                                                   compact_wire=False)
            serial = jax_step.make_train_step(loss_fn, tx,
                                              compact_wire=False)
            state, fused_losses = fused(state, data[:2], lrs[:2], rng, 0)
            state, tail_loss, _ = serial(state, data[2], lrs[2],
                                         jax.random.fold_in(rng, 2))
        # frozen leaves hold no trace (optax.MaskedNode): zeros there
        trace = jax.tree_util.tree_map(
            lambda t, p: (np.zeros(np.shape(p)) if isinstance(
                t, optax.MaskedNode) else np.asarray(t)),
            jax_trace(state.opt_state), state.params,
            is_leaf=lambda x: isinstance(x, optax.MaskedNode))
        return {"params": params, "stats": stats, "lrs": lrs, "data": data,
                "losses": [float(x) for x in np.asarray(fused_losses)]
                + [float(tail_loss)],
                "after": sd64(state.params, state.batch_stats),
                "trace": sd64(trace, {})}


def port_epoch(init, fuse):
    """The port's epoch of 3 steps on the JAX epoch's weights and batches
    at float64: losses, the state_dict and the momentum buffers by name."""
    cfg = pemp_stage1.ex.assemble("train", dict(
        a.split("=", 1) for a in SMALL + [
            "dev.compact_wire=False", "loss=cedt", f"dev.fuse_steps={fuse}"]
        + [f"{k}={v}" for k, v in TR.items()]))
    model = PEMPStage1(backbone="resnet50", protos=3, drop_rate=0.0,
                       layers=(1, 1, 1))
    model.load_state_dict(state_dict_from_jax(init["params"], init["stats"]))
    model = model.double().train()
    params = model.freeze()
    lr_policy = PolyLike(0.025)
    trainer = Trainer(cfg, Run(None, None), model,
                      solver.make_optimizer(cfg.tr, params), params,
                      pemp_stage1.Stage1Runtime(cfg), lr_policy,
                      torch.device("cpu"), fuse_steps=fuse)
    losses = []
    assert trainer._run_epoch(init["data"], losses, Timer(), GracefulStop(),
                              1) == 3
    names = {id(p): k for k, p in model.named_parameters()}
    momentum = {names[id(p)]: s["momentum_buffer"]
                for p, s in trainer.optimizer.state.items()}
    return {"losses": torch.cat([x.reshape(-1) for x in losses]).tolist(),
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "momentum": momentum,
            "launches": (None if trainer.train_step_fused is None
                         else trainer.train_step_fused.eager_steps)}


def test_stage1_fused_epoch_matches_serial_and_jax(jax_epoch):
    fused = port_epoch(jax_epoch, 2)
    serial = port_epoch(jax_epoch, 1)
    assert fused["launches"] == 2        # one chunk of two; the tail serial
    # on the CPU a fused launch is the serial loop's steps: bit for bit
    assert fused["losses"] == serial["losses"]
    for key, value in serial["state"].items():
        assert torch.equal(fused["state"][key], value), key
    assert fused["momentum"].keys() == serial["momentum"].keys()
    for key, value in serial["momentum"].items():
        assert torch.equal(fused["momentum"][key], value), key
    # and the JAX package's fused epoch
    np.testing.assert_allclose(fused["losses"], jax_epoch["losses"], rtol=REL)
    after = jax_epoch["after"]
    state = fused["state"]
    assert set(after) == {k for k in state if not k.endswith("_tracked")}
    assert_leaves_close(state, after, REL, "params and statistics")
    assert len(fused["momentum"]) > 0
    assert_leaves_close(fused["momentum"],
                        {k: jax_epoch["trace"][k] for k in fused["momentum"]},
                        REL, "momentum")


# --- CaNet's history store ------------------------------------------------------

def canet_snapshots(fuse, model_dir):
    """CaNet trained on the CPU (one block a stage) for two epochs of four
    steps, unrecorded (its final snapshot under ``model_dir``); the live
    store's contents at each ``next_epoch()``."""
    entry = importlib.import_module("pemp_tpu_torch.entry.canet")
    cfg = entry.ex.assemble("train", dict(a.split("=", 1) for a in SMALL + [
        "data.train_n=8", "tr.total_epochs=2", f"dev.fuse_steps={fuse}",
        f"g.model_dir={model_dir}"]))
    with worker.shallow():
        rt = entry.CaNetRuntime(cfg, Run(None, None))
        store, next_epoch = rt.store, rt.store.next_epoch
        snapshots = []

        def recording_next_epoch():
            snapshots.append({k: v.copy() for k, v in store._store.items()})
            next_epoch()

        store.next_epoch = recording_next_epoch
        result = rt.train()
    return result["train"]["losses"], snapshots


def test_canet_fused_history_store_is_the_serial_one(tmp_path):
    losses_s, snap_s = canet_snapshots(1, tmp_path)
    losses_f, snap_f = canet_snapshots(3, tmp_path)  # a chunk of 3, a tail
    assert losses_f == losses_s and len(losses_s) == 8
    assert len(snap_s) == len(snap_f) > 2
    assert any(snap_s)
    for a, b in zip(snap_s, snap_f):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            assert a[key].tobytes() == b[key].tobytes(), key


# --- the update at a tensor LR, checkpoints -------------------------------------

@pytest.mark.parametrize("opt, nesterov, dtype", [
    ("sgd", False, torch.float32), ("sgd", True, torch.float32),
    ("sgd", False, torch.float64), ("adam", False, torch.float32)])
def test_tensor_lr_update_equals_the_optimizer_at_a_float_lr(opt, nesterov,
                                                             dtype):
    tr = SimpleNamespace(opt=opt, lr=0.1, sgd_momentum=0.9,
                         sgd_nesterov=nesterov, weight_decay=5e-4,
                         adam_beta1=0.9, adam_beta2=0.999, adam_epsilon=1e-8)
    rng = np.random.RandomState(0)
    init = [torch.from_numpy(rng.randn(*s)).to(dtype) for s in
            ((7, 3), (5,), (2, 4, 3))]
    grads = [[torch.from_numpy(rng.randn(*p.shape)).to(dtype) for p in init]
             for _ in range(5)]

    def run(tensor_lr):
        params = [torch.nn.Parameter(p.clone()) for p in init]
        optimizer = solver.make_optimizer(tr, params)
        lr_t = solver.lr_tensor("cpu")
        for i, gs in enumerate(grads):
            for p, g in zip(params, gs):
                p.grad = g.clone()
            lr = 0.1 / (1 + i)
            solver.set_lr(optimizer, lr)
            if tensor_lr:
                lr_t.fill_(lr)
                solver.step(optimizer, lr_t)
            else:
                optimizer.step()
        return params, optimizer

    want, opt_want = run(False)
    got, opt_got = run(True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(got, want):
        sg, sw = opt_got.state[g], opt_want.state[w]
        assert sg.keys() == sw.keys() and sg
        for key in sw:
            assert torch.equal(sg[key], sw[key]), key
    # the groups keep their float LR (the checkpoints record it)
    assert opt_got.param_groups[0]["lr"] == pytest.approx(0.1 / 5)
    assert isinstance(opt_got.param_groups[0]["lr"], float)


def test_fused_checkpoint_equals_the_serial_one_and_resumes_serially(
        tmp_path):
    args = ["train", "with", *SMALL, "data.train_n=6", "loss=cedt",
            "tr.total_epochs=1"]
    runs = {}
    for fuse in (2, 1):
        root = tmp_path / f"fuse{fuse}"
        first = pemp_stage1.main(args + [f"dev.fuse_steps={fuse}",
                                         f"g.model_dir={root}"])
        ckpt = ckpt_lib.load(root / "pemp_stage1" / "1" / ckpt_lib.CKPT)
        # both resume serially for a second epoch
        again = pemp_stage1.main([a for a in args if a != "tr.total_epochs=1"]
                                 + ["tr.total_epochs=2", "resume=True",
                                    "exp_id=1", f"g.model_dir={root}"])
        runs[fuse] = (first["train"]["losses"], ckpt,
                      again["train"]["losses"])
    (f_loss, f_ckpt, f_again), (s_loss, s_ckpt, s_again) = runs[2], runs[1]
    assert f_loss == s_loss and len(f_loss) == 3
    assert f_again == s_again and len(f_again) == 3
    assert f_ckpt["epoch"] == s_ckpt["epoch"] == 1
    for key, value in s_ckpt["model"].items():
        assert torch.equal(f_ckpt["model"][key], value), key
    f_opt, s_opt = f_ckpt["optimizer"], s_ckpt["optimizer"]
    assert f_opt["param_groups"] == s_opt["param_groups"]
    assert f_opt["state"].keys() == s_opt["state"].keys() and s_opt["state"]
    for key, value in s_opt["state"].items():
        assert torch.equal(f_opt["state"][key]["momentum_buffer"],
                           value["momentum_buffer"]), key


# --- PEMP_PROFILE_DIR -----------------------------------------------------------

def test_profile_dir_traces_the_second_epoch_only(tmp_path, monkeypatch):
    from pemp_tpu_torch.entry import baseline
    args = ["train", "with", *SMALL, "data.train_n=4", "tr.total_epochs=2",
            "net.backbone=vgg16", "-u"]
    monkeypatch.delenv("PEMP_PROFILE_DIR", raising=False)
    baseline.main(args + [f"g.model_dir={tmp_path / 'plain'}"])
    assert not list(tmp_path.rglob("*.json"))
    traces = tmp_path / "traces"
    monkeypatch.setenv("PEMP_PROFILE_DIR", str(traces))
    baseline.main(args + [f"g.model_dir={tmp_path / 'traced'}",
                          "dev.fuse_steps=2"])
    assert [p.name for p in traces.iterdir()] == ["epoch2_rank0.pt.trace.json"]
    trace = json.loads((traces / "epoch2_rank0.pt.trace.json").read_text())
    assert trace["traceEvents"]
