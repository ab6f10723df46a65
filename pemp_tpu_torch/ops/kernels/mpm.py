"""Wrappers of the meta-prototype CUDA kernels (``csrc/mpm.cu``,
``csrc/mpm_bwd.cu``).

Replaces the TPU kernels of ``pemp_tpu/ops/pallas/mpm.py``:

- ``mpm_assign``  <- ``_assign_kernel`` / ``meta_prototype_assign_pallas``
  (K1): soft assignment of the support pixels to the learned centers and
  the per-episode adaptive prototypes, one launch (block partials summed
  per cluster of blocks, then the last block of each episode sums the
  cluster partials in a fixed order);
- ``mpm_match``   <- ``_match_kernel`` / ``prototype_match_pallas`` (K2):
  cosine matching against the prototypes, per-class max and
  first-occurrence argmax;
- ``mpm_chain_packed`` <- ``mpm_chain_packed_pallas`` (K3): K1 then K2 on
  the un-split purifier output ``[B, S+Q, n, c]``; the kernels pick the
  support rows ``(i//S)(S+Q)+i%S`` and query rows ``(i//Q)(S+Q)+S+i%Q``
  themselves, so no split copy is made;
- ``MPMChainPacked`` <- the custom VJPs of ``pemp_tpu/ops/pallas/mpm_vjp.py``
  (K4): K1 and K2 forward; backward the two kernels of ``csrc/mpm_bwd.cu``
  (``match_bwd`` on the query rows, then ``assign_bwd`` on the support
  rows), which reuse K1's cluster partials of the forward.

For a tensor on the CPU each wrapper runs the plain version
(``pemp_tpu_torch.ops.prototypes``; for the backward ``_match_backward``
and ``_assign_backward``, the JAX package's jnp backward in PyTorch ops);
for a CUDA tensor it launches its kernels or raises. ``launches`` counts
each ``__global__`` kernel's launches on CUDA, one at the site that
launches it: ``assign`` (K1), ``match`` (K2), ``match_bwd`` and
``assign_bwd`` (K4). The chain launches nothing of its own;
``backward_calls`` counts ``MPMChainPacked`` backward passes on either
device.

K1 and K2 are also the ``torch.library`` operators ``pemp::mpm_assign``
(``assign_op``) and ``pemp::mpm_match`` (``match_op``), with a CUDA
implementation (the launch above), a CPU one (the plain version) and a
fake one (shapes and dtypes, for ``torch.export``); no other device has
one. The public wrappers and the no-grad chain call them, so an exported
eval forward holds them as graph nodes and launches the kernels on the
card (``tools/export_serving.py``). Importing this module registers
them: load an exported program after it.

The plain versions of the kernels' stages: ``plain_assign_blocks``
and ``plain_assign_finish`` (K1: the partial sums of each cluster of
blocks, ``CLUSTER`` times ``assign_grid``'s rows per block, and the
fixed-order finish of an episode); ``plain_match_bwd_blocks``,
``plain_shot_sums``, ``plain_match_bwd_finish``,
``plain_assign_bwd_blocks`` and ``plain_assign_bwd_finish`` (K4: the
block partials of each backward kernel and their finishes). The kernels'
tickets are kept per device, stream and kernel: launches of one stream
run in order and leave them at zero.

Under CUDA-graph capture (``parallel/step.py``'s fused train step) a
wrapper records its kernel into the graph on the capture stream.
``launches`` counts that call, and a replay adds nothing to it (the
fused step counts what its replays launched). A captured kernel reads
only memory made before the capture or in the graph's pool: a ticket
buffer is never freed once made (a graph keeps its pointer), and
neither it nor a plan (the occupancy queries) may be made under
capture, where a miss raises; an eager call on the capture stream at
the same shapes makes both.
"""

from __future__ import annotations

import ctypes
from functools import partial
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from pemp_tpu_torch.ops.dtypes import f32up
from pemp_tpu_torch.ops.kernels.build import load_library
from pemp_tpu_torch.ops.prototypes import (
    ASSIGN_EPS, COS_EPS, meta_prototype_assign, prototype_predictions,
    soft_assignment,
)

MAX_PROTOS = 8           # csrc/mpm_common.cuh kMaxProtos
STAGE_ROWS = 32          # csrc/mpm_common.cuh kStageRows (rows per ring stage)
CLUSTER = 2              # csrc/mpm.cu kCluster (assign blocks per cluster)
PASS_CHANNELS = 512      # csrc/mpm_common.cuh kPassCols (channels a pass)

launches: Dict[str, int] = {"assign": 0, "match": 0, "match_bwd": 0,
                            "assign_bwd": 0}
backward_calls: Dict[str, int] = {"mpm_backward": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_bound: Dict[str, ctypes.CDLL] = {}
_plans: Dict[tuple, Tuple[int, int]] = {}   # (ring stages, slots) per kernel
_ticket_bufs: Dict[tuple, torch.Tensor] = {}
_retired: List[torch.Tensor] = []           # outgrown tickets, kept alive
_BWD_KIND = {"match_bwd": 0, "assign_bwd": 1}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0
    backward_calls["mpm_backward"] = 0


def _not_capturing(what: str) -> None:
    """Raise under CUDA-graph capture: ``what`` must exist before it."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} is made under CUDA-graph capture: run "
                           "the step eagerly on the capture stream first")


def _lib():
    if "mpm" not in _bound:
        lib = load_library("mpm")
        lib.pemp_mpm_assign.argtypes = [_P, _I, _P, _P, _P, _P, _P, _P, _P,
                                        _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                        _F, _P]
        lib.pemp_mpm_assign.restype = _I
        lib.pemp_mpm_assign_slots.argtypes = [_I, _I, _I]
        lib.pemp_mpm_assign_slots.restype = _I
        lib.pemp_mpm_assign_stages.argtypes = [_I, _I, _I]
        lib.pemp_mpm_assign_stages.restype = _I
        lib.pemp_mpm_match.argtypes = [_P, _I, _P, _P, _P, _I, _I, _I, _I,
                                       _I, _I, _I, _I, _I, _F, _F, _P]
        lib.pemp_mpm_match.restype = _I
        lib.pemp_mpm_match_plan.argtypes = [_I, _I, _I, _IP]
        lib.pemp_mpm_match_plan.restype = _I
        lib.pemp_cuda_error_string.argtypes = [_I]
        lib.pemp_cuda_error_string.restype = ctypes.c_char_p
        for name, want in (("pemp_mpm_max_protos", MAX_PROTOS),
                           ("pemp_mpm_stage_rows", STAGE_ROWS),
                           ("pemp_mpm_cluster", CLUSTER),
                           ("pemp_mpm_pass_channels", PASS_CHANNELS)):
            fn = getattr(lib, name)
            fn.restype = _I
            if fn() != want:
                raise RuntimeError(f"{name}() = {fn()} != {want}: the "
                                   "wrapper and csrc/mpm.cu disagree")
        _bound["mpm"] = lib
    return _bound["mpm"]


def _bwd_lib():
    if "mpm_bwd" not in _bound:
        lib = load_library("mpm_bwd")
        lib.pemp_mpm_match_bwd.argtypes = (
            [_P, _I] + [_P] * 11 + [_I] * 10 + [_F, _F, _F, _P])
        lib.pemp_mpm_match_bwd.restype = _I
        lib.pemp_mpm_assign_bwd.argtypes = (
            [_P, _I] + [_P] * 14 + [_I] * 9 + [_P])
        lib.pemp_mpm_assign_bwd.restype = _I
        lib.pemp_mpm_bwd_plan.argtypes = [_I, _I, _I, _I, _IP]
        lib.pemp_mpm_bwd_plan.restype = _I
        lib.pemp_cuda_error_string.argtypes = [_I]
        lib.pemp_cuda_error_string.restype = ctypes.c_char_p
        _bound["mpm_bwd"] = lib
    return _bound["mpm_bwd"]


def _check_rc(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({lib.pemp_cuda_error_string(rc).decode()})")


def _check_features(fts: torch.Tensor, protos: int) -> None:
    if fts.device.type != "cuda":
        raise ValueError(f"features on {fts.device}, expected cuda")
    if fts.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"features dtype {fts.dtype}: the kernels take "
                        "float32 or bfloat16")
    if fts.ndim != 4:
        raise ValueError(f"features must be [B, S+Q, n, c], got "
                         f"{tuple(fts.shape)}")
    if not fts.is_contiguous():
        raise ValueError("features must be contiguous")
    if fts.shape[-1] % 8 or fts.data_ptr() % 16:
        raise ValueError("the channel count must be a multiple of 8 and "
                         "the features 16-byte aligned (vector loads)")
    if not 1 <= protos <= MAX_PROTOS:
        raise ValueError(f"protos={protos} outside [1, {MAX_PROTOS}]")


def _f32_on(x: torch.Tensor, device, shape, what: str) -> torch.Tensor:
    if x.device != device:
        raise ValueError(f"{what} on {x.device}, features on {device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    return x.to(torch.float32).contiguous()


def assign_grid(n: int, images: int, slots: int,
                cluster: int = CLUSTER) -> Tuple[int, int]:
    """(blocks per image, pixel rows per block) of a row kernel: the
    blocks the card holds at once (``slots``, whole clusters) split evenly
    over the ``images`` (images times column passes) in whole clusters of
    ``cluster`` blocks, each block at least one ring stage of rows; blocks
    past n (to fill the last cluster) take no rows. The assign kernel at
    n=2601 on 128 slots: 16 blocks of 163 rows for 8 images, 32 of 82 for
    4. The match and backward kernels have no clusters (``cluster=1``)."""
    per_image = max(1, slots // images // cluster) * cluster
    rows = max(STAGE_ROWS, -(-n // per_image))
    blocks = -(-n // rows)
    return -(-blocks // cluster) * cluster, rows


def _assign_plan(lib, device, c: int, protos: int, is_bf16: int):
    """(ring stages, blocks the card holds at once) of the assign kernel
    for (c, p) and the feature type on ``device``."""
    key = (device, c, protos, is_bf16)
    if key not in _plans:
        _not_capturing(f"the assign plan {key}")
        with torch.cuda.device(device):
            stages = lib.pemp_mpm_assign_stages(c, protos, is_bf16)
            if stages == 0:
                raise ValueError(f"c={c}, p={protos}: the assign kernel's "
                                 "smallest ring does not fit in a block's "
                                 "shared memory")
            slots = lib.pemp_mpm_assign_slots(c, protos, is_bf16)
        _check_rc(lib, -min(slots, 0), "assign occupancy")
        if slots == 0:
            raise RuntimeError(f"no assign block (c={c}, p={protos}) fits "
                               "on an SM")
        _plans[key] = (stages, slots)
    return _plans[key]


def _ring_plan(kind: str, fn, device, c: int, protos: int,
               is_bf16: int) -> Tuple[int, int]:
    """(ring stages, blocks the card holds at once) of the match or a
    backward kernel for (c, p) and the feature type on ``device``;
    ``fn(c, p, is_bf16, slots_ptr)`` is its planning C entry. Stages 0:
    the kernel reads its rows from device memory (no ring fits)."""
    key = (kind, device, c, protos, is_bf16)
    if key not in _plans:
        _not_capturing(f"the {kind} plan {key}")
        slots = ctypes.c_int(0)
        with torch.cuda.device(device):
            stages = fn(c, protos, is_bf16, ctypes.byref(slots))
        if stages < 0 or slots.value <= 0:
            raise ValueError(f"c={c}, p={protos}: the {kind} kernel does not "
                             "fit a block's shared memory")
        _plans[key] = (stages, slots.value)
    return _plans[key]


def _tickets(device, stream: int, kind: str, count: int) -> torch.Tensor:
    """A kernel's int32 tickets on (device, stream): zeroed once, left at
    zero by every launch. An outgrown buffer stays alive: a captured graph
    may hold its pointer."""
    key = (device, stream, kind)
    t = _ticket_bufs.get(key)
    if t is None or t.numel() < count:
        _not_capturing(f"the {kind} tickets on stream {stream:#x}")
        if t is not None:
            _retired.append(t)
        t = torch.zeros(count, dtype=torch.int32, device=device)
        _ticket_bufs[key] = t
    return t


def _assign_launch(fts, sup_fg, sup_bg, ctr, protos: int, eps: float,
                   partials: bool = False):
    """K1 on CUDA, one launch -> packed prototypes [B, 2p, c] (fg first,
    then bg) and, with ``partials``, its cluster partials num [B*S, T, 2p,
    c] and den [B*S, T, 2p] (what the backward reads)."""
    _check_features(fts, protos)
    b, sq, n, c = fts.shape
    s = sup_fg.shape[1]
    if not 1 <= s <= sq:
        raise ValueError(f"{s} support images in a packed axis of {sq}")
    fg = _f32_on(sup_fg, fts.device, (b, s, n), "sup_fg")
    bg = _f32_on(sup_bg, fts.device, (b, s, n), "sup_bg")
    ctr = _f32_on(ctr, fts.device, (c, 2 * protos), "ctr")
    if ctr.data_ptr() % 16:                   # the kernel copies it in 16 B
        ctr = ctr.clone()
    lib = _lib()
    is_bf16 = int(fts.dtype == torch.bfloat16)
    stages, slots = _assign_plan(lib, fts.device, c, protos, is_bf16)
    tiles, rows = assign_grid(n, b * s * -(-c // PASS_CHANNELS), slots)
    k2 = 2 * protos
    num = torch.empty((b * s, tiles // CLUSTER, k2, c), dtype=torch.float32,
                      device=fts.device)
    den = torch.empty((b * s, tiles // CLUSTER, k2), dtype=torch.float32,
                      device=fts.device)
    out = torch.empty((b, k2, c), dtype=torch.float32, device=fts.device)
    stream = torch.cuda.current_stream(fts.device).cuda_stream
    tickets = _tickets(fts.device, stream, "assign", b)
    rc = lib.pemp_mpm_assign(fts.data_ptr(), is_bf16, fg.data_ptr(),
                             bg.data_ptr(), ctr.data_ptr(), num.data_ptr(),
                             den.data_ptr(), tickets.data_ptr(),
                             out.data_ptr(), b, s, sq - s, n, c, protos,
                             rows, tiles, stages, float(eps), stream)
    _check_rc(lib, rc, "assign")
    launches["assign"] += 1
    return (out, num, den) if partials else out


def _row_blocks(x: torch.Tensor, rows: int) -> torch.Tensor:
    """[I, n, m] -> [I, T, rows, m], T = cdiv(n, rows), zero rows past n."""
    i, n, m = x.shape
    pad = -(-n // rows) * rows - n
    return F.pad(x, (0, 0, 0, pad)).reshape(i, -1, rows, m)


def plain_assign_blocks(fts, sup_fg, sup_bg, ctr, protos: int, rows: int):
    """Plain version of the assign kernel's cluster partials: for each
    support image and run of ``rows`` pixel rows (a cluster's: CLUSTER
    times the rows per block), ``num = a^T f`` [2p, c] and ``den = sum a``
    [2p] of the soft assignment ``a``. Returns num [B*S, T, 2p, c] and den
    [B*S, T, 2p] float32, T = cdiv(n, rows)."""
    s = sup_fg.shape[1]
    f = fts[:, :s].float()
    b, _, n, c = f.shape
    a = soft_assignment(f, sup_fg, sup_bg, ctr, protos)
    f = _row_blocks(f.reshape(b * s, n, c), rows)
    a = _row_blocks(a.reshape(b * s, n, 2 * protos), rows)
    return torch.einsum("itrk,itrc->itkc", a, f), a.sum(dim=2)


def plain_assign_finish(num, den, b: int, s: int, eps: float = ASSIGN_EPS):
    """Plain version of the assign kernel's last block of an episode: sum
    the cluster partials in order, ``num / (den + eps)``, mean over the S
    shots -> [B, 2p, c]."""
    proto = num.sum(dim=1) / (den.sum(dim=1)[..., None] + eps)
    return proto.reshape(b, s, *proto.shape[1:]).mean(dim=1)


def _match_launch(fts, s: int, packed, protos: int, dist_scalar: float,
                  return_indices: bool):
    """K2 on CUDA: query rows fts[:, s:] against packed [B, 2p, c]."""
    _check_features(fts, protos)
    b, sq, n, c = fts.shape
    q = sq - s
    if q < 1:
        raise ValueError(f"no query images: S={s} of a packed axis of {sq}")
    packed = _f32_on(packed, fts.device, (b, 2 * protos, c), "prototypes")
    lib = _lib()
    is_bf16 = int(fts.dtype == torch.bfloat16)
    stages, slots = _ring_plan("match", lib.pemp_mpm_match_plan,
                               fts.device, c, protos, is_bf16)
    tiles, rows = assign_grid(n, b * q, slots, cluster=1)
    logits = torch.empty((b, q, n, 2), dtype=torch.float32, device=fts.device)
    inds = (torch.empty((b, q, n, 2), dtype=torch.int32, device=fts.device)
            if return_indices else None)
    stream = torch.cuda.current_stream(fts.device).cuda_stream
    rc = lib.pemp_mpm_match(fts.data_ptr(), is_bf16, packed.data_ptr(),
                            logits.data_ptr(),
                            inds.data_ptr() if inds is not None else None,
                            b, s, q, n, c, protos, rows, tiles, stages,
                            float(dist_scalar), COS_EPS, stream)
    _check_rc(lib, rc, "match")
    launches["match"] += 1
    return (logits, inds) if return_indices else logits


def _plain_dtype(*tensors: torch.Tensor) -> torch.dtype:
    """The plain versions' result dtype: at least float32 (``f32up``)."""
    dtype = torch.float32
    for t in tensors:
        dtype = torch.promote_types(dtype, t.dtype)
    return dtype


@torch.library.custom_op("pemp::mpm_assign", mutates_args=(),
                         device_types="cpu")
def assign_op(fts: torch.Tensor, sup_fg: torch.Tensor, sup_bg: torch.Tensor,
              ctr: torch.Tensor, protos: int, eps: float) -> torch.Tensor:
    """K1 as an operator: packed prototypes [B, 2p, c] (fg first, then bg)
    of the support rows of fts [B, S+Q, n, c]. This body is its CPU
    implementation, the plain version; for CUDA tensors the kernel."""
    s = sup_fg.shape[1]
    fg, bg = meta_prototype_assign(fts[:, :s], sup_fg, sup_bg, ctr, protos,
                                   eps)
    return torch.cat([fg, bg], dim=1)


@assign_op.register_kernel("cuda")
def _assign_cuda(fts, sup_fg, sup_bg, ctr, protos, eps):
    return _assign_launch(fts, sup_fg, sup_bg, ctr, protos, eps)


@assign_op.register_fake
def _assign_fake(fts, sup_fg, sup_bg, ctr, protos, eps):
    return fts.new_empty((fts.shape[0], 2 * protos, fts.shape[-1]),
                         dtype=_plain_dtype(fts, sup_fg, sup_bg, ctr))


@torch.library.custom_op("pemp::mpm_match", mutates_args=(),
                         device_types="cpu")
def match_op(fts: torch.Tensor, s: int, packed: torch.Tensor, protos: int,
             dist_scalar: float, return_indices: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 as an operator: logits [B, Q, n, 2] of the query rows
    ``fts[:, s:]`` against packed [B, 2p, c], and the int32 argmax indices
    [B, Q, n, 2] (an empty [0] tensor unless ``return_indices``). This body
    is its CPU implementation, the plain version; for CUDA tensors the
    kernel."""
    return _pair(prototype_predictions(
        fts[:, s:], packed[:, :protos], packed[:, protos:], dist_scalar,
        return_indices), return_indices, fts)


@match_op.register_kernel("cuda")
def _match_cuda(fts, s, packed, protos, dist_scalar, return_indices):
    return _pair(_match_launch(fts, s, packed, protos, dist_scalar,
                               return_indices), return_indices, fts)


@match_op.register_fake
def _match_fake(fts, s, packed, protos, dist_scalar, return_indices):
    b, sq, n, _ = fts.shape
    shape = (b, sq - s, n, 2)
    return (fts.new_empty(shape, dtype=_plain_dtype(fts, packed)),
            fts.new_empty(shape if return_indices else (0,),
                          dtype=torch.int32))


def _pair(out, return_indices: bool, fts: torch.Tensor):
    """(logits, indices): an empty index tensor when none was asked for
    (an operator returns a fixed number of tensors)."""
    if return_indices:
        return out
    return out, torch.empty((0,), dtype=torch.int32, device=fts.device)


def mpm_assign(fts: torch.Tensor, sup_fg: torch.Tensor, sup_bg: torch.Tensor,
               ctr: torch.Tensor, protos: int, eps: float = ASSIGN_EPS
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adaptive prototypes from the support rows of packed features.

    fts [B, S+Q, n, c] (Q may be 0); the first S = ``sup_fg.shape[1]``
    images of each episode are the support. sup_fg / sup_bg [B, S, n],
    ctr [c, 2p]. Returns (fg_proto, bg_proto), each [B, p, c] float32.
    """
    out = assign_op(fts, sup_fg, sup_bg, ctr, protos, eps)
    return out[:, :protos], out[:, protos:]


def mpm_match(fts: torch.Tensor, s: int, fg_proto: torch.Tensor,
              bg_proto: torch.Tensor, dist_scalar: float = 20.0,
              return_indices: bool = False):
    """Cosine logits of the query rows ``fts[:, s:]`` against per-class
    prototypes fg_proto / bg_proto [B, p, c]. Returns logits [B, Q, n, 2]
    ([bg, fg]) and, if asked, int32 argmax indices [B, Q, n, 2]."""
    packed = torch.cat([fg_proto, bg_proto], dim=1)
    logits, inds = match_op(fts, s, packed, fg_proto.shape[1], dist_scalar,
                            return_indices)
    return (logits, inds) if return_indices else logits


def _norm_and_guard(x: torch.Tensor):
    """``_safe_norm``'s value and the ``sq >= 1e-30`` gate its gradient
    implies."""
    sq = (x * x).sum(dim=-1)
    return torch.sqrt(torch.clamp(sq, min=1e-30)), sq >= 1e-30


def _assign_backward(sup_fts, sup_fg, sup_bg, ctr, g_proto, protos: int,
                     eps: float):
    """Cotangents of (sup_fts, sup_fg, sup_bg, ctr) from the packed
    prototype cotangent g_proto [B, 2p, c] (``_assign_bwd``,
    ``pemp_tpu/ops/pallas/mpm_vjp.py:63-112``). The softmax assignment is
    recomputed from the four inputs, not saved."""
    f = f32up(sup_fts)
    c32 = ctr.to(f.dtype)
    b, s, n, c = f.shape
    k = protos
    f_sq = (f * f).sum(dim=-1, keepdim=True)                      # [B,S,n,1]
    c_sq = (c32 * c32).sum(dim=0)                                 # [2k]
    dist = -(f_sq - 2.0 * torch.einsum("bsnc,ck->bsnk", f, c32) + c_sq)
    sm5 = torch.softmax(dist.reshape(b, s, n, 2, k), dim=-1)      # [B,S,n,2,k]
    mask2 = torch.stack([sup_fg, sup_bg], dim=-1).to(f.dtype)     # [B,S,n,2]
    a = (sm5 * mask2[..., None]).reshape(b, s, n, 2 * k)
    num = torch.einsum("bsnc,bsnk->bskc", f, a)                   # [B,S,2k,c]
    den = a.sum(dim=2)[..., None] + eps                           # [B,S,2k,1]

    # proto = mean_s(num / den)
    gq = g_proto.to(f.dtype)[:, None] / s                         # [B,1,2k,c]
    g_num = gq / den
    g_den = -(gq * num).sum(dim=-1, keepdim=True) / (den * den)
    g_a = (torch.einsum("bsnc,bskc->bsnk", f, g_num)
           + g_den[..., 0][:, :, None, :])                        # [B,S,n,2k]
    g_f = torch.einsum("bsnk,bskc->bsnc", a, g_num)

    # a = softmax(dist | class) * mask
    g_a5 = g_a.reshape(b, s, n, 2, k)
    g_mask2 = (sm5 * g_a5).sum(dim=-1)                            # [B,S,n,2]
    g_sm5 = g_a5 * mask2[..., None]
    g_d5 = sm5 * (g_sm5 - (sm5 * g_sm5).sum(dim=-1, keepdim=True))
    g_dist = g_d5.reshape(b, s, n, 2 * k)

    # dist = -(f_sq - 2 f.ctr + c_sq)
    g_fc = 2.0 * g_dist
    g_row = g_dist.sum(dim=-1, keepdim=True)
    g_f = g_f - 2.0 * f * g_row + torch.einsum("bsnk,ck->bsnc", g_fc, c32)
    g_ctr = (torch.einsum("bsnc,bsnk->ck", f, g_fc)
             - 2.0 * c32 * g_dist.sum(dim=(0, 1, 2))[None, :])
    return g_f, g_mask2[..., 0], g_mask2[..., 1], g_ctr


def _match_backward(qry_fts, packed, inds, g, protos: int,
                    dist_scalar: float, cos_eps: float = COS_EPS):
    """Cotangents of (qry_fts, packed prototypes [B, 2p, c]) from the
    logit cotangent g [B, Q, n, 2] (``_match_bwd``, ``mpm_vjp.py:146-186``).
    The max over p sends each row's gradient only to its argmax prototype
    (``inds``, written by the forward), as a one-hot mask."""
    q = f32up(qry_fts)
    qn, q_live = _norm_and_guard(q)                               # [B,Q,n]
    col = torch.arange(protos, device=q.device)

    def class_backward(proto, idx, g_cls):
        p = proto.to(q.dtype)
        pn, p_live = _norm_and_guard(p)                           # [B,k]
        dot = torch.einsum("bqnc,bkc->bqnk", q, p)
        d_raw = qn[..., None] * pn[:, None, None, :]              # [B,Q,n,k]
        d_cl = torch.clamp(d_raw, min=cos_eps)
        g_cos = ((idx[..., None] == col).to(q.dtype)
                 * g_cls[..., None].to(q.dtype) * dist_scalar)
        g_dot = g_cos / d_cl
        g_d = torch.where(d_raw >= cos_eps, -g_cos * dot / (d_cl * d_cl),
                          torch.zeros_like(dot))
        g_qn = (g_d * pn[:, None, None, :]).sum(dim=-1)           # [B,Q,n]
        g_pn = (g_d * qn[..., None]).sum(dim=(1, 2))              # [B,k]
        g_q = (torch.einsum("bqnk,bkc->bqnc", g_dot, p)
               + torch.where(q_live, g_qn / qn, torch.zeros_like(qn))[..., None]
               * q)
        g_p = (torch.einsum("bqnk,bqnc->bkc", g_dot, q)
               + torch.where(p_live, g_pn / pn, torch.zeros_like(pn))[..., None]
               * p)
        return g_q, g_p

    # class order of the logits is [bg, fg]; packed holds fg then bg
    g_q_bg, g_bg = class_backward(packed[:, protos:], inds[..., 0], g[..., 0])
    g_q_fg, g_fg = class_backward(packed[:, :protos], inds[..., 1], g[..., 1])
    return g_q_bg + g_q_fg, torch.cat([g_fg, g_bg], dim=1)


def plain_match_bwd_blocks(qry_fts, packed, inds, g, protos: int,
                           dist_scalar: float, rows: int,
                           cos_eps: float = COS_EPS):
    """Plain version of the match_bwd kernel's rows: the query cotangent
    g_q [B, Q, n, c] and, for each query image and run of ``rows`` pixel
    rows (a block's), the partials of the prototype cotangent before its
    norm term, ``gp = g_dot^T q`` [2p, c], and of ``gpn = sum g_d |q|``
    [2p], with the max over p one-hot at the forward's indices (packed
    order: fg columns, then bg). Returns g_q, gp [B*Q, T, 2p, c] and gpn
    [B*Q, T, 2p] float32."""
    q = f32up(qry_fts)
    b, nq, n, c = q.shape
    k2 = 2 * protos
    p = packed.float()
    qn, q_live = _norm_and_guard(q)                               # [B,Q,n]
    pn, _ = _norm_and_guard(p)                                    # [B,2p]
    cols = torch.stack([inds[..., 0].long() + protos, inds[..., 1].long()],
                       dim=-1)                                    # [B,Q,n,2]
    g_cos = (F.one_hot(cols, k2).to(q.dtype)
             * g.to(q.dtype)[..., None]).sum(dim=3) * dist_scalar  # [B,Q,n,2p]
    dot = torch.einsum("bqnc,bkc->bqnk", q, p)
    d_raw = qn[..., None] * pn[:, None, None, :]
    d_cl = torch.clamp(d_raw, min=cos_eps)
    g_dot = g_cos / d_cl
    g_d = torch.where(d_raw >= cos_eps, -g_cos * dot / (d_cl * d_cl),
                      torch.zeros_like(dot))
    g_qn = (g_d * pn[:, None, None, :]).sum(dim=-1)
    g_q = (torch.einsum("bqnk,bkc->bqnc", g_dot, p)
           + torch.where(q_live, g_qn / qn, torch.zeros_like(qn))[..., None] * q)
    gd_blocks = _row_blocks(g_dot.reshape(b * nq, n, k2), rows)
    gp = torch.einsum("itrk,itrc->itkc", gd_blocks,
                      _row_blocks(q.reshape(b * nq, n, c), rows))
    gpn = _row_blocks((g_d * qn[..., None]).reshape(b * nq, n, k2),
                      rows).sum(dim=2)
    return g_q, gp, gpn


def plain_shot_sums(num, den, eps: float = ASSIGN_EPS):
    """Per-shot sums of the assign kernel's cluster partials (num [B*S, T,
    2p, c], den [B*S, T, 2p]): num_s [B*S, 2p, c] and den_s + eps [B*S, 2p],
    the sums the backward would otherwise recompute."""
    return num.sum(dim=1), den.sum(dim=1) + eps


def plain_match_bwd_finish(gp, gpn, packed, num, den, s: int,
                           eps: float = ASSIGN_EPS):
    """Plain version of the match_bwd kernel's finish of each episode: the
    block partials summed, ``g_packed = gp + (p_live ? gpn / pn : 0) p``
    [B, 2p, c]; then for each shot, from the forward's partials,
    ``g_num = g_packed / S / den_s`` [B*S, 2p, c] and ``g_den = -sum_c
    (g_packed / S * num_s) / den_s^2`` [B*S, 2p]. Returns (g_packed, g_num,
    g_den)."""
    p = packed.float()
    b = p.shape[0]
    pn, p_live = _norm_and_guard(p)
    gp_sum = gp.reshape(b, -1, *gp.shape[2:]).sum(dim=1)
    gpn_sum = gpn.reshape(b, -1, gpn.shape[-1]).sum(dim=1)
    g_packed = gp_sum + torch.where(p_live, gpn_sum / pn,
                                    torch.zeros_like(pn))[..., None] * p
    num_s, den_s = plain_shot_sums(num, den, eps)
    gq = g_packed.repeat_interleave(s, dim=0) / s
    g_num = gq / den_s[..., None]
    g_den = -(gq * num_s).sum(dim=-1) / (den_s * den_s)
    return g_packed, g_num, g_den


def plain_assign_bwd_blocks(sup_fts, sup_fg, sup_bg, ctr, g_num, g_den,
                            protos: int, rows: int):
    """Plain version of the assign_bwd kernel's rows: from g_num [B*S, 2p,
    c] and g_den [B*S, 2p] (the match_bwd finish), the feature cotangent
    g_f [B, S, n, c], the mask cotangents g_fg, g_bg [B, S, n] and, for
    each support image and run of ``rows`` pixel rows, the partials of the
    centers' cotangent ``gc = (2 g_dist)^T f`` [2p, c] and of ``gd = sum
    g_dist`` [2p]. Returns (g_f, g_fg, g_bg, gc [B*S, T, 2p, c], gd [B*S,
    T, 2p]) float32."""
    f = f32up(sup_fts)
    c32 = ctr.to(f.dtype)
    b, s, n, c = f.shape
    k = protos
    g_num = g_num.reshape(b, s, 2 * k, c)
    f_sq = (f * f).sum(dim=-1, keepdim=True)
    c_sq = (c32 * c32).sum(dim=0)
    dist = -(f_sq - 2.0 * torch.einsum("bsnc,ck->bsnk", f, c32) + c_sq)
    sm5 = torch.softmax(dist.reshape(b, s, n, 2, k), dim=-1)
    mask2 = torch.stack([sup_fg, sup_bg], dim=-1).to(f.dtype)
    a = (sm5 * mask2[..., None]).reshape(b, s, n, 2 * k)
    g_a5 = (torch.einsum("bsnc,bskc->bsnk", f, g_num)
            + g_den.reshape(b, s, 1, 2 * k)).reshape(b, s, n, 2, k)
    g_mask2 = (sm5 * g_a5).sum(dim=-1)
    g_sm5 = g_a5 * mask2[..., None]
    g_dist = (sm5 * (g_sm5 - (sm5 * g_sm5).sum(dim=-1, keepdim=True))
              ).reshape(b, s, n, 2 * k)
    g_f = (torch.einsum("bsnk,bskc->bsnc", a, g_num)
           - 2.0 * f * g_dist.sum(dim=-1, keepdim=True)
           + torch.einsum("bsnk,ck->bsnc", 2.0 * g_dist, c32))
    gd_blocks = _row_blocks(g_dist.reshape(b * s, n, 2 * k), rows)
    gc = torch.einsum("itrk,itrc->itkc", 2.0 * gd_blocks,
                      _row_blocks(f.reshape(b * s, n, c), rows))
    return g_f, g_mask2[..., 0], g_mask2[..., 1], gc, gd_blocks.sum(dim=2)


def plain_assign_bwd_finish(gc, gd, ctr):
    """Plain version of the assign_bwd kernel's finishes: every partial
    summed, ``g_ctr = gc^T - 2 ctr gd`` [c, 2p]."""
    return (gc.sum(dim=(0, 1)).transpose(0, 1)
            - 2.0 * ctr.float() * gd.sum(dim=(0, 1))[None, :])


def _backward_launch(fts, sup_fg, sup_bg, ctr, packed, inds, num, den, g,
                     protos: int, dist_scalar: float, eps: float,
                     masks: bool):
    """K4 on CUDA, two launches: match_bwd (query rows, then per episode
    g_num and g_den from the forward's partials num, den) and assign_bwd
    (support rows, then g_ctr). Returns (g_fts in fts.dtype, g_fg and g_bg
    [B, S, n] float32 or None unless ``masks``, g_ctr [c, 2p] float32)."""
    _check_features(fts, protos)
    b, sq, n, c = fts.shape
    s = sup_fg.shape[1]
    q, k2, dev = sq - s, 2 * protos, fts.device
    fg = _f32_on(sup_fg, dev, (b, s, n), "sup_fg")
    bg = _f32_on(sup_bg, dev, (b, s, n), "sup_bg")
    ctr = _f32_on(ctr, dev, (c, k2), "ctr")
    g = _f32_on(g, dev, (b, q, n, 2), "logit cotangent")
    if ctr.data_ptr() % 16:                   # the kernel copies it in 16 B
        ctr = ctr.clone()
    lib = _bwd_lib()
    is_bf16 = int(fts.dtype == torch.bfloat16)
    passes = -(-c // PASS_CHANNELS)
    ns_m, slots_m = _ring_plan("match_bwd", partial(
        lib.pemp_mpm_bwd_plan, _BWD_KIND["match_bwd"]), dev, c, protos,
        is_bf16)
    ns_a, slots_a = _ring_plan("assign_bwd", partial(
        lib.pemp_mpm_bwd_plan, _BWD_KIND["assign_bwd"]), dev, c, protos,
        is_bf16)
    tiles_m, rows_m = assign_grid(n, b * q * passes, slots_m, cluster=1)
    tiles_a, rows_a = assign_grid(n, b * s * passes, slots_a, cluster=1)
    # one float32 scratch, each piece 16-byte aligned: g_num, g_den, the
    # match_bwd block partials (gp, gpn), the assign_bwd block and image
    # partials (gc, gd)
    sizes = (b * s * k2 * c, b * s * k2, b * q * tiles_m * k2 * c,
             b * q * tiles_m * k2, b * s * tiles_a * k2 * c,
             b * s * tiles_a * k2, b * s * k2 * c, b * s * k2)
    offsets, total = [], 0
    for size in sizes:
        offsets.append(total)
        total += -(-size // 4) * 4
    scratch = torch.empty(total, dtype=torch.float32, device=dev)
    g_num, g_den, gp, gpn, gc, gd, gc_img, gd_img = (
        scratch.data_ptr() + 4 * o for o in offsets)
    g_fts = torch.empty_like(fts)
    g_ctr = torch.empty((c, k2), dtype=torch.float32, device=dev)
    g_fg = g_bg = None
    if masks:
        g_fg = torch.empty((b, s, n), dtype=torch.float32, device=dev)
        g_bg = torch.empty((b, s, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = _tickets(dev, stream, "match_bwd", b)
    rc = lib.pemp_mpm_match_bwd(
        fts.data_ptr(), is_bf16, packed.data_ptr(), inds.data_ptr(),
        g.data_ptr(), num.data_ptr(), den.data_ptr(), g_fts.data_ptr(), gp,
        gpn, tickets.data_ptr(), g_num, g_den, b, s, q, n, c, protos, rows_m,
        tiles_m, ns_m, num.shape[1], float(dist_scalar), COS_EPS, float(eps),
        stream)
    _check_rc(lib, rc, "match_bwd")
    launches["match_bwd"] += 1
    tickets = _tickets(dev, stream, "assign_bwd", b * s + 1)
    rc = lib.pemp_mpm_assign_bwd(
        fts.data_ptr(), is_bf16, fg.data_ptr(), bg.data_ptr(), ctr.data_ptr(),
        g_num, g_den, g_fts.data_ptr(),
        g_fg.data_ptr() if masks else None, g_bg.data_ptr() if masks else None,
        gc, gd, gc_img, gd_img, tickets.data_ptr(), g_ctr.data_ptr(), b, s, q,
        n, c, protos, rows_a, tiles_a, ns_a, stream)
    _check_rc(lib, rc, "assign_bwd")
    launches["assign_bwd"] += 1
    return g_fts, g_fg, g_bg, g_ctr


class MPMChainPacked(torch.autograd.Function):
    """Differentiable assign-then-match on the packed features (K4; the
    custom VJP ``mpm_packed_fused``, ``pemp_tpu/ops/pallas/mpm_vjp.py:197-230``).

    Forward: on CUDA, K1 then K2 with the argmax indices; on the CPU the
    plain composition. The packed prototypes [B, 2p, c] and the int32
    indices are kept for the backward, and on CUDA K1's cluster partials
    too. Backward: on CUDA the two kernels of ``csrc/mpm_bwd.cu`` (counted
    as ``match_bwd`` and ``assign_bwd``); on the CPU its plain version,
    ``_match_backward`` then ``_assign_backward`` in PyTorch ops (at least
    float32), as the JAX package's is jnp outside any kernel. Ties of the
    max over p send the gradient to the first occurrence (autodiff of the
    plain version splits it; measure zero for real features).
    ``backward_calls["mpm_backward"]`` counts backward passes.
    """

    @staticmethod
    def forward(ctx, fts, sup_fg, sup_bg, ctr, protos: int,
                dist_scalar: float, eps: float):
        s = sup_fg.shape[1]
        if fts.device.type == "cpu":
            fg, bg = meta_prototype_assign(fts[:, :s], sup_fg, sup_bg, ctr,
                                           protos, eps)
            packed = torch.cat([fg, bg], dim=1)
            logits, inds = prototype_predictions(fts[:, s:], fg, bg,
                                                 dist_scalar, True)
            partials = ()
        else:
            packed, *partials = _assign_launch(fts, sup_fg, sup_bg, ctr,
                                               protos, eps, partials=True)
            logits, inds = _match_launch(fts, s, packed, protos, dist_scalar,
                                         True)
        ctx.save_for_backward(fts, sup_fg, sup_bg, ctr, packed, inds,
                              *partials)
        ctx.protos, ctx.dist_scalar, ctx.eps = protos, dist_scalar, eps
        return logits

    @staticmethod
    def backward(ctx, g):
        fts, sup_fg, sup_bg, ctr, packed, inds, *partials = ctx.saved_tensors
        backward_calls["mpm_backward"] += 1
        need = ctx.needs_input_grad
        s = sup_fg.shape[1]
        if fts.device.type == "cpu":
            g_qry, g_packed = _match_backward(fts[:, s:], packed, inds, g,
                                              ctx.protos, ctx.dist_scalar)
            g_sup, g_fg, g_bg, g_ctr = _assign_backward(
                fts[:, :s], sup_fg, sup_bg, ctr, g_packed, ctx.protos,
                ctx.eps)
            g_fts = torch.cat([g_sup, g_qry], dim=1).to(fts.dtype)
        else:
            g_fts, g_fg, g_bg, g_ctr = _backward_launch(
                fts, sup_fg, sup_bg, ctr, packed, inds, *partials, g,
                ctx.protos, ctx.dist_scalar, ctx.eps, need[1] or need[2])
        return (g_fts if need[0] else None,
                g_fg.to(sup_fg.dtype) if need[1] else None,
                g_bg.to(sup_bg.dtype) if need[2] else None,
                g_ctr.to(ctr.dtype) if need[3] else None,
                None, None, None)


def mpm_chain_packed(fts: torch.Tensor, sup_fg: torch.Tensor,
                     sup_bg: torch.Tensor, ctr: torch.Tensor, protos: int,
                     dist_scalar: float = 20.0, return_indices: bool = False,
                     eps: float = ASSIGN_EPS):
    """Assign then match on the packed purifier output fts [B, S+Q, n, c]
    (S = ``sup_fg.shape[1]``). Returns logits [B, Q, n, 2] and, if asked,
    the argmax indices [B, Q, n, 2]. With grad enabled and an input that
    requires it, the logits come from ``MPMChainPacked`` (same kernels
    forward, analytic backward); otherwise from the operators
    ``pemp::mpm_assign`` then ``pemp::mpm_match`` (the eval and serving
    path, which ``torch.export`` keeps as two graph nodes)."""
    s = sup_fg.shape[1]
    if (not return_indices and torch.is_grad_enabled()
            and any(t.requires_grad for t in (fts, sup_fg, sup_bg, ctr))):
        return MPMChainPacked.apply(fts, sup_fg, sup_bg, ctr, protos,
                                    dist_scalar, eps)
    packed = assign_op(fts, sup_fg, sup_bg, ctr, protos, eps)
    logits, inds = match_op(fts, s, packed, protos, dist_scalar,
                            return_indices)
    return (logits, inds) if return_indices else logits
