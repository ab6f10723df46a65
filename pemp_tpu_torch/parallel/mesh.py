"""The process world: one process per card, data parallel over episodes.

Counterpart of ``pemp_tpu/parallel/mesh.py``. The JAX package runs one
process per host over a mesh of that host's chips, and GSPMD inserts the
collectives; the port follows PyTorch: one process per card, a
``torch.distributed`` world (NCCL on CUDA, gloo on the CPU and where
several processes share a card), ``DistributedDataParallel`` for the
gradient mean, and the collectives below for what the JAX mesh makes
global by construction (``parallel/step.py``: batch statistics, loss
denominators, eval gathers). There is no single-process mesh of
several cards: ``dev.mesh > 1`` in one process raises.

- ``_launch_env`` / ``initialize_distributed``: a world from the
  environment (``COORDINATOR_ADDRESS`` + ``NUM_PROCESSES`` +
  ``PROCESS_ID``, ``torchrun``'s ``RANK`` / ``WORLD_SIZE`` /
  ``MASTER_ADDR`` / ``MASTER_PORT``, or Slurm's task ids), with a finite
  collective timeout (``PEMP_DIST_TIMEOUT_S``, default 600 s), before any
  run folder is made;
- ``resolve_mesh``: ``dev.mesh`` against the world;
- ``process_episode_range`` / ``process_episode_indices``: the train
  loader's equal-length, rank-strided, wrap-around padded shards;
- ``broadcast_scalar_from_rank0``, ``any_process_flag``,
  ``broadcast_bytes_from_rank0``: host values agreed across the world;
- ``all_reduce_sum``, ``world_mean``, ``gather_rows``: device tensors
  reduced or gathered in global batch order (all through ``all_reduce``
  and ``broadcast``, which both backends take for CUDA tensors);
- ``require_graph_collectives``: a fused launch (``dev.fuse_steps > 1``)
  captures the train step's collectives (DDP's gradient all-reduce,
  ``GlobalBatchNorm``'s and ``world_mean``'s) in a CUDA graph, which can
  hold NCCL's but not gloo's: on CUDA a gloo world (processes sharing a
  card) raises. On the CPU the fused launch is k eager steps, over gloo
  as any world there.
"""

from __future__ import annotations

import datetime
import os
import struct
import sys
from dataclasses import dataclass

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0
CHUNK = 1 << 28         # bytes a broadcast carries at most (256 MiB)


# --- the world --------------------------------------------------------------

def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _host_device() -> torch.device:
    """Where host values travel for a collective: NCCL takes CUDA tensors
    only, gloo the CPU's."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _launch_env():
    """The launcher's environment: ``"explicit"`` (``COORDINATOR_ADDRESS``
    + ``NUM_PROCESSES`` + ``PROCESS_ID``, or ``torchrun``'s ``RANK`` +
    ``WORLD_SIZE`` + ``MASTER_ADDR`` + ``MASTER_PORT``), ``"auto"`` (a Slurm
    job of several tasks) or None (one process). A partial explicit set
    raises. A TPU pod's ``TPU_WORKER_HOSTNAMES`` has no counterpart."""
    for keys in (("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"),
                 ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        if keys[0] in os.environ:
            missing = [k for k in keys[1:] if k not in os.environ]
            if missing:
                raise RuntimeError(
                    f"{keys[0]} is set but {missing} are not; a "
                    f"multi-process launch needs all of {list(keys)}")
            return "explicit"
    if "SLURM_JOB_NUM_NODES" in os.environ \
            and int(os.environ.get("SLURM_NTASKS", "1")) > 1:
        return "auto"
    return None


def _launch_spec():
    """(``tcp://`` address, world size, rank, local rank) of the launch."""
    env = os.environ
    if "COORDINATOR_ADDRESS" in env:
        rank, world = int(env["PROCESS_ID"]), int(env["NUM_PROCESSES"])
        addr = env["COORDINATOR_ADDRESS"]
    elif "RANK" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    else:           # Slurm: its task ids, the address from the job script
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT") if k not in env]
        if missing:
            raise RuntimeError(
                f"a Slurm job of several tasks needs {missing} exported "
                "(the first node's address and a free port)")
        rank, world = int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"])
        addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    local = int(env.get("LOCAL_RANK", env.get("SLURM_LOCALID", rank)))
    return f"tcp://{addr}", world, rank, local


def _local_world():
    """The most processes the launch puts on one node: ``torchrun``'s
    ``LOCAL_WORLD_SIZE``, or Slurm's tasks per node (``"8"``, or per-node
    counts such as ``"8(x2),4"``); None when the launcher does not say
    (the ``COORDINATOR_ADDRESS`` triple without ``LOCAL_WORLD_SIZE``)."""
    env = os.environ
    if "LOCAL_WORLD_SIZE" in env:
        return int(env["LOCAL_WORLD_SIZE"])
    tasks = env.get("SLURM_NTASKS_PER_NODE") or env.get("SLURM_TASKS_PER_NODE")
    if tasks:
        return max(int(part.split("(")[0]) for part in tasks.split(","))
    return None


def choose_backend(device: str, world: int, cards: int) -> str:
    """The world's backend: NCCL when every process of a CUDA launch has
    a card of its own, gloo on the CPU and where the processes of a node
    outnumber its cards and so share them. The decision is the same on
    every rank (it reads the most processes on any node). A CUDA launch
    of more processes than this node has cards, whose launcher does not
    say how many run on each node, raises: gloo would move every
    collective through the host on a multi-node job."""
    if torch.device(device).type != "cuda":
        return "gloo"
    if world <= cards:
        return "nccl"
    local = _local_world()
    if local is None:
        raise RuntimeError(
            f"a world of {world} processes on a node of {cards} cards: set "
            "LOCAL_WORLD_SIZE to the processes each node runs (torchrun "
            "and Slurm say it themselves)")
    return "nccl" if local <= cards else "gloo"


def initialize_distributed(device: str = "cuda") -> bool:
    """Join the world the environment describes; True when a world exists
    (launched now or before), False for a plain single process.

    On CUDA each process binds ``LOCAL_RANK``'s card and the world runs
    over NCCL, unless a node runs more processes than it has cards, which
    then share them over gloo (``choose_backend``); ``device="cpu"`` runs
    over gloo. Rank 0 prints the backend to stderr. Every
    collective times out after ``PEMP_DIST_TIMEOUT_S`` seconds, so a
    world whose peer died raises instead of hanging. A broken launch
    raises."""
    if dist.is_initialized():
        return True
    if _launch_env() is None:
        return False
    addr, world, rank, local = _launch_spec()
    cards = 0
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass dev.device=cpu to run the "
                "world on the CPU over gloo")
        cards = torch.cuda.device_count()
        torch.cuda.set_device(local % cards)
    backend = choose_backend(device, world, cards)
    if rank == 0:
        shared = " (processes share the cards)" if backend == "gloo" \
            and cards else ""
        print(f"pemp_tpu_torch: a world of {world} processes over "
              f"{backend}{shared}", file=sys.stderr, flush=True)
    timeout = float(os.environ.get("PEMP_DIST_TIMEOUT_S", DEFAULT_TIMEOUT_S))
    dist.init_process_group(backend, init_method=addr, world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    # the first collective builds the communicators while the ranks are
    # still aligned by the rendezvous
    any_process_flag(False)
    return True


def resolve_mesh(n: int) -> int:
    """``dev.mesh`` -> the number of processes that share each batch.

    ``0`` (auto) and ``-1`` take the whole world; under a launch of W
    processes anything else but W raises (a partial world would train
    diverging replicas). One process drives one card, so ``n > 1``
    without a launch raises: start W processes with ``torchrun
    --nproc_per_node=W``."""
    world = process_count()
    if n in (0, -1) or n == world:
        return world
    if world == 1:
        raise ValueError(
            f"dev.mesh={n}: one process drives one card; launch {n} "
            f"processes with `torchrun --nproc_per_node={n} -m "
            "pemp_tpu_torch.entry.<entry> ...` (dev.mesh=0 takes them all)")
    raise ValueError(
        f"multi-process launch ({world} processes) requires dev.mesh to "
        f"cover the whole world; got dev.mesh={n}. Leave dev.mesh=0 "
        f"(auto) or set it to {world}.")


# --- host-side sharding ------------------------------------------------------

def process_episode_range(n_episodes: int, rank=None, world=None):
    """[start, stop) of the global episode list owned by process ``rank``
    of ``world`` (the live world by default)."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    per = -(-n_episodes // world)
    return min(rank * per, n_episodes), min((rank + 1) * per, n_episodes)


def process_episode_indices(n_episodes: int, rank=None, world=None):
    """Equal-length per-process episode lists, rank-strided and
    wrap-around padded (``DistributedSampler``'s semantics): every process
    runs the same number of steps (the gradient all-reduce is synchronous),
    and step ``s`` of W processes at batch ``bs`` holds episodes
    ``[s*W*bs, (s+1)*W*bs)`` of the stream, the global batch one process
    at ``W*bs`` would draw; rank r holds its rows r, r+W, ..."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    if n_episodes == 0:
        return []
    per = -(-n_episodes // world)
    return [(rank + i * world) % n_episodes for i in range(per)]


@dataclass(frozen=True)
class RowShard:
    """This process's rows of a global train batch under the strided
    shard: ``episodes`` local episodes, global episode ``W*j + rank`` its
    row j. ``local`` picks them from a tensor of the global batch laid
    out episode-major (k rows an episode), e.g. a dropout mask drawn for
    the global batch."""
    rank: int
    world: int
    episodes: int

    def local(self, t: torch.Tensor) -> torch.Tensor:
        rows = t.reshape(self.episodes, self.world, -1, *t.shape[1:])
        return rows[:, self.rank].reshape(-1, *t.shape[1:])


# --- host values across the world --------------------------------------------

def broadcast_scalar_from_rank0(value: int) -> int:
    """Rank 0's integer on every process (e.g. the run id rank 0
    allocated)."""
    if process_count() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=_host_device())
    dist.broadcast(t, 0)
    return int(t.item())


def any_process_flag(flag: bool) -> bool:
    """World-OR of a host boolean (e.g. "this rank was told to stop").
    Every process calls it the same number of times."""
    if process_count() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=_host_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def broadcast_bytes_from_rank0(data) -> bytes:
    """Rank 0's bytes (a checkpoint) on every process; the other ranks'
    argument is ignored. ``b""`` when rank 0 had none: the empty payload
    is rank 0's failure signal, so every rank raises instead of waiting
    in the broadcast. An int64 length header, then chunks of at most
    256 MiB, whose count every rank derives from the agreed length."""
    if process_count() == 1:
        return data or b""
    is_src = process_index() == 0
    device = _host_device()
    n = len(data) if (is_src and data) else 0
    hdr = torch.frombuffer(bytearray(struct.pack("<q", n)), dtype=torch.uint8)
    hdr = hdr.to(device)
    dist.broadcast(hdr, 0)
    n = struct.unpack("<q", bytes(hdr.cpu().tolist()))[0]
    if n == 0:
        return b""
    src = memoryview(data) if is_src else None
    pieces = []
    for off in range(0, n, CHUNK):
        m = min(CHUNK, n - off)
        if is_src:
            part = torch.frombuffer(bytearray(src[off:off + m]),
                                    dtype=torch.uint8).to(device)
        else:
            part = torch.empty(m, dtype=torch.uint8, device=device)
        dist.broadcast(part, 0)
        pieces.append(part.cpu().numpy().tobytes())
    return b"".join(pieces)


# --- device tensors across the world -----------------------------------------

def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The world's sum of ``t`` (a new tensor; ``t`` itself is kept)."""
    if process_count() == 1:
        return t
    t = t.clone()
    dist.all_reduce(t)
    return t


def world_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the processes (e.g. each rank's share of the
    global loss, which is the global loss)."""
    world = process_count()
    return t if world == 1 else all_reduce_sum(t) / world


def gather_rows(t: torch.Tensor, strided: bool = False) -> torch.Tensor:
    """Every process's rows of a batch tensor, in global order: rank r's
    rows are block r (``strided=False``, the eval split) or rows r, r+W, ...
    (``strided=True``, the train shard). Through ``all_reduce`` of a
    zero-padded tensor, which is exact (every other term is 0) and which
    gloo takes for CUDA tensors too."""
    world = process_count()
    if world == 1:
        return t
    rank = process_index()
    if strided:
        out = t.new_zeros((t.shape[0], world) + t.shape[1:])
        out[:, rank] = t
    else:
        out = t.new_zeros((world,) + t.shape)
        out[rank] = t
    dist.all_reduce(out)
    return out.reshape((-1,) + t.shape[1:])


def require_graph_collectives(fuse_steps: int) -> None:
    """Raise unless a CUDA graph can hold this world's collectives: one
    process, or a world over NCCL."""
    if dist.is_initialized() and dist.get_backend() != "nccl":
        raise RuntimeError(
            f"dev.fuse_steps={fuse_steps} captures the train step, with its "
            "collectives, in a CUDA graph, which can hold NCCL collectives "
            f"but not {dist.get_backend()}'s (this world's: processes that "
            "share a card run over gloo); run one process per card over "
            "NCCL, or dev.fuse_steps=1")
