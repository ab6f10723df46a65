"""The port's ``parallel/`` in one process, held against
``pemp_tpu.parallel`` on the same inputs:

- ``device_batch`` + ``unpack_batch`` give the JAX package's values and
  dtypes bit for bit, with and without the compact wire, the query GT at
  another size than the images left on the host;
- ``process_episode_indices`` / ``process_episode_range`` over worlds of
  1-4 processes and 0, 1, 7, 8 episodes;
- ``_launch_env`` over the JAX package's environment cases
  (``tests/test_multichip.py::test_launch_env_detection``), ``torchrun``'s
  and Slurm's; the backend of single- and multi-node launches;
  ``resolve_mesh``'s errors; the ``dev`` keys' defaults;
- the ``DevicePrefetcher``'s order, host keys, error and early exit;
- the dropout masks of a world: each rank's rows of the global batch's
  masks, those one process draws;
- a read error of rank 0's resume checkpoint raises on every rank.
"""

import threading
import time

import numpy as np
import pytest
import torch

from pemp_tpu.config.base import DeviceConfig as JaxDeviceConfig
from pemp_tpu.parallel import mesh as jax_mesh
from pemp_tpu.parallel import step as jax_step
from pemp_tpu_torch.config import DeviceConfig
from pemp_tpu_torch.models.layers import DropBlock, Dropout2d
from pemp_tpu_torch.parallel import mesh, step

CPU = torch.device("cpu")


def host_batch(rng, gt_hw=(9, 9)):
    """A seeded batch of 3 episodes (S=2, Q=1) in the loader's dtypes."""
    b, s, q, h, w = 3, 2, 1, 9, 9
    fg = (rng.rand(b, s, h, w, 1) > 0.5).astype(np.float32)
    msk = rng.randint(0, 2, (b, q) + gt_hw).astype(np.int32)
    msk[:, :, 0, :3] = 255
    return {
        "sup_rgb": rng.randn(b, s, h, w, 3).astype(np.float32),
        "sup_mask": np.concatenate([fg, 1 - fg], -1),
        "qry_rgb": rng.randn(b, q, h, w, 3).astype(np.float32),
        "qry_msk": msk,
        "history": rng.rand(b, q, 2, 2, 2).astype(np.float32),
        "qry_prior": rng.randint(0, 2, (b, q, h, w)).astype(np.float32),
        "cls": np.array([1, 2, 3], np.int32),
        "qry_names": [["a"], ["b"], ["c"]],
    }


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("gt_hw", [(9, 9), (7, 11)])
def test_device_batch_and_unpack_equal_the_jax_package(compact, gt_hw):
    batch = host_batch(np.random.RandomState(3), gt_hw)
    want = jax_step.unpack_batch(jax_step.device_batch(
        batch, compact_wire=compact))
    got = step.unpack_batch(step.device_batch(batch, CPU, compact))
    assert set(got) == set(want)
    assert ("qry_msk" in got) == (gt_hw == (9, 9))
    for key, value in want.items():
        value = np.asarray(value)
        out = got[key].numpy()
        assert out.dtype == value.dtype, key
        np.testing.assert_array_equal(out, value, err_msg=key)
    # the wire itself: float16 images, uint8 masks, as the JAX package sends
    wire = step.device_batch(batch, CPU, compact)
    jwire = jax_step.device_batch(batch, compact_wire=compact)
    for key, value in jwire.items():
        assert wire[key].numpy().dtype == np.asarray(value).dtype, key
    # device tensors pass through untouched
    again = step.device_batch({**batch, **wire}, CPU, compact)
    assert all(again[k] is wire[k] for k in wire)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [0, 1, 7, 8])
def test_episode_shards_equal_the_jax_package(world, n):
    seen = []
    for rank in range(world):
        got = mesh.process_episode_indices(n, rank, world)
        assert got == jax_mesh.process_episode_indices(n, rank, world)
        assert mesh.process_episode_range(n, rank, world) == \
            jax_mesh.process_episode_range(n, rank, world)
        seen.extend(got)
    # equal lengths, every episode covered
    assert len(seen) == world * (-(-n // world) if n else 0)
    assert set(seen) == set(range(n))


LAUNCH_VARS = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
               "TPU_WORKER_HOSTNAMES", "SLURM_JOB_NUM_NODES", "SLURM_NTASKS",
               "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# (environment, the port's answer, the JAX package's answer; "raise" for
# a RuntimeError)
LAUNCH_CASES = [
    ({}, None, None),
    ({"TPU_WORKER_HOSTNAMES": "host0"}, None, None),
    # a TPU pod has no counterpart in the port
    ({"TPU_WORKER_HOSTNAMES": "host0,host1"}, None, "auto"),
    ({"COORDINATOR_ADDRESS": "10.0.0.1:1234"}, "raise", "raise"),
    ({"COORDINATOR_ADDRESS": "10.0.0.1:1234", "NUM_PROCESSES": "4"},
     "raise", "raise"),
    ({"COORDINATOR_ADDRESS": "10.0.0.1:1234", "NUM_PROCESSES": "4",
      "PROCESS_ID": "0"}, "explicit", "explicit"),
    ({"SLURM_JOB_NUM_NODES": "2", "SLURM_NTASKS": "8"}, "auto", "auto"),
    ({"SLURM_JOB_NUM_NODES": "1", "SLURM_NTASKS": "1"}, None, None),
    # torchrun's variables: the port's explicit launch, unknown to JAX
    ({"RANK": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
      "MASTER_PORT": "29500"}, "explicit", None),
    ({"RANK": "0", "WORLD_SIZE": "2"}, "raise", None),
]


@pytest.mark.parametrize("env,port,jax_answer", LAUNCH_CASES)
def test_launch_env(monkeypatch, env, port, jax_answer):
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    for fn, want in ((mesh._launch_env, port),
                     (jax_mesh._launch_env, jax_answer)):
        if want == "raise":
            with pytest.raises(RuntimeError):
                fn()
        else:
            assert fn() == want


# (launch environment, world size, cards on this node, the backend or
# "raise")
BACKEND_CASES = [
    ({}, 1, 1, "nccl"),
    ({"LOCAL_WORLD_SIZE": "2"}, 2, 1, "gloo"),           # a shared card
    # torchrun across two nodes of eight cards each
    ({"LOCAL_WORLD_SIZE": "8"}, 16, 8, "nccl"),
    # Slurm across two nodes, with and without --ntasks-per-node
    ({"SLURM_JOB_NUM_NODES": "2", "SLURM_NTASKS": "16",
      "SLURM_TASKS_PER_NODE": "8(x2)"}, 16, 8, "nccl"),
    ({"SLURM_JOB_NUM_NODES": "2", "SLURM_NTASKS": "12",
      "SLURM_TASKS_PER_NODE": "8,4"}, 12, 8, "nccl"),
    ({"SLURM_JOB_NUM_NODES": "1", "SLURM_NTASKS": "4",
      "SLURM_NTASKS_PER_NODE": "4", "SLURM_TASKS_PER_NODE": "4"}, 4, 2,
     "gloo"),
    # the COORDINATOR_ADDRESS triple across nodes: the per-node count
    # comes from LOCAL_WORLD_SIZE, and without it the launch raises
    ({"COORDINATOR_ADDRESS": "10.0.0.1:1234", "NUM_PROCESSES": "16",
      "PROCESS_ID": "9"}, 16, 8, "raise"),
    ({"COORDINATOR_ADDRESS": "10.0.0.1:1234", "NUM_PROCESSES": "16",
      "PROCESS_ID": "9", "LOCAL_WORLD_SIZE": "8"}, 16, 8, "nccl"),
    ({"COORDINATOR_ADDRESS": "10.0.0.1:1234", "NUM_PROCESSES": "4",
      "PROCESS_ID": "1"}, 4, 8, "nccl"),
]


@pytest.mark.parametrize("env,world,cards,want", BACKEND_CASES)
def test_backend_of_a_launch(monkeypatch, env, world, cards, want):
    for var in (*LAUNCH_VARS, "LOCAL_WORLD_SIZE", "SLURM_NTASKS_PER_NODE",
                "SLURM_TASKS_PER_NODE"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    assert mesh.choose_backend("cpu", world, 0) == "gloo"
    if want == "raise":
        with pytest.raises(RuntimeError, match="LOCAL_WORLD_SIZE"):
            mesh.choose_backend("cuda", world, cards)
    else:
        assert mesh.choose_backend("cuda", world, cards) == want


def test_resolve_mesh_and_the_dev_keys(monkeypatch):
    for n in (0, -1, 1):
        assert mesh.resolve_mesh(n) == 1
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=2"):
        mesh.resolve_mesh(2)
    monkeypatch.setattr(mesh, "process_count", lambda: 4)
    for n in (0, -1, 4):
        assert mesh.resolve_mesh(n) == 4
    for n in (1, 2, 8):
        with pytest.raises(ValueError, match="dev.mesh"):
            mesh.resolve_mesh(n)
    # the JAX package's defaults of tpu.mesh, tpu.prefetch, tpu.compact_wire,
    # tpu.fuse_steps
    ours, theirs = DeviceConfig(), JaxDeviceConfig()
    for key in ("mesh", "prefetch", "compact_wire", "fuse_steps"):
        assert getattr(ours, key) == getattr(theirs, key), key


class ListLoader:
    """A loader over fixed batches; ``fail_at`` raises at that batch."""

    def __init__(self, batches, fail_at=None):
        self.batches = batches
        self.fail_at = fail_at
        self.served = 0

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for i, b in enumerate(self.batches):
            if i == self.fail_at:
                raise KeyError("loader broke")
            self.served += 1
            yield b


def test_prefetcher_order_error_and_early_exit():
    rng = np.random.RandomState(0)
    batches = [host_batch(rng) for _ in range(6)]
    pre = step.DevicePrefetcher(ListLoader(batches), CPU, depth=2)
    assert len(pre) == 6
    got = list(pre)
    assert len(got) == 6
    for b, g in zip(batches, got):
        assert g["qry_names"] == b["qry_names"]           # host keys kept
        assert g["cls"] is b["cls"]
        assert g["sup_rgb"].dtype == torch.float16
        np.testing.assert_array_equal(
            g["sup_rgb"].float().numpy(),
            b["sup_rgb"].astype(np.float16).astype(np.float32))
    # the producer's error reaches the consumer, after the batches before it
    pre = step.DevicePrefetcher(ListLoader(batches, fail_at=3), CPU)
    seen = []
    with pytest.raises(KeyError, match="loader broke"):
        for b in pre:
            seen.append(b)
    assert len(seen) == 3
    # a consumer that leaves early: the thread ends, holding no batch
    before = threading.active_count()
    loader = ListLoader(batches)
    it = iter(step.DevicePrefetcher(loader, CPU, depth=1))
    next(it)
    it.close()
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    assert loader.served <= 4            # one yielded, at most depth + 2 read


@pytest.mark.parametrize("module", ["dropblock", "dropout2d"])
def test_dropout_masks_of_a_world_are_the_global_batch_rows(module):
    """2 processes, 2 episodes each of k=3 images: rank r's masks are rows
    of the global batch's (global episode 2j + r), the rescale the global
    one; together they are what one process draws at 4 episodes."""
    world, episodes, k = 2, 2, 3
    x = torch.rand(world * episodes * k, 4, 9, 9,
                   generator=torch.Generator().manual_seed(1)) + 0.5

    def layer(shard, seed):
        m = DropBlock(0.3, 3) if module == "dropblock" else Dropout2d(0.3)
        m.generator = torch.Generator().manual_seed(seed)
        m.shard = shard
        return m.train()
    want = layer(None, 7)(x)
    eps = x.reshape(world * episodes, k, 4, 9, 9)
    for rank in range(world):
        shard = mesh.RowShard(rank, world, episodes)
        local = eps[rank::world].reshape(-1, 4, 9, 9)
        got = layer(shard, 7)(local)
        expect = want.reshape(world * episodes, k, 4, 9, 9)[rank::world]
        torch.testing.assert_close(got, expect.reshape(-1, 4, 9, 9),
                                   rtol=0, atol=0)
    assert (want == 0).any() and (want != 0).any()


def test_resume_read_error_on_rank0_raises_on_every_rank(monkeypatch,
                                                         tmp_path):
    """As ``tests/test_multichip.py::test_maybe_resume_rank0_read_error_
    raises``: rank 0 cannot read the checkpoint it found; it raises, and a
    rank holding no run folder raises from rank 0's broadcast flag."""
    from types import SimpleNamespace

    from pemp_tpu_torch.config import Config
    from pemp_tpu_torch.core import trainer as trainer_mod

    def tiny_trainer(rank, root):
        monkeypatch.setattr(mesh, "process_index", lambda: rank)
        cfg = Config(split=0)
        cfg.g.model_dir = str(root)
        run = SimpleNamespace(_id=1 if rank == 0 else None)
        model = torch.nn.Linear(2, 2)
        return trainer_mod.Trainer(cfg, run, model, None, [], None, None,
                                   CPU)
    tr = tiny_trainer(0, tmp_path)
    tr.model_dir.mkdir(parents=True)
    (tr.model_dir / "ckpt.pt").write_bytes(b"present")
    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    monkeypatch.setattr(mesh, "broadcast_scalar_from_rank0", lambda v: v)

    def unreadable(self):
        raise OSError("disk error")
    monkeypatch.setattr(type(tr.model_dir), "read_bytes", unreadable)
    with pytest.raises(RuntimeError, match="could not read.*disk error"):
        tr.maybe_resume()
    monkeypatch.undo()
    tr = tiny_trainer(1, tmp_path / "r1")
    monkeypatch.setattr(mesh, "process_count", lambda: 2)
    monkeypatch.setattr(mesh, "broadcast_scalar_from_rank0", lambda v: 1)
    with pytest.raises(RuntimeError, match="could not read"):
        tr.maybe_resume()
