"""Checkpoint save/load, and the JAX package's ``.msgpack`` checkpoints.

Counterpart of ``pemp_tpu/core/checkpoint.py``: a checkpoint is
``torch.save`` of ``{"model": state_dict, "optimizer": state_dict,
"epoch": int, "extra": dict}``, where ``extra`` holds the trainer state a
resume needs (``best_iou``, ``best_epoch``, the ``lr_policy`` state). The
trainer writes ``ckpt.pt`` every ``tr.ckpt_epoch`` epochs and
``bestckpt.pt`` on the best online-eval mIoU. ``model_state`` also takes
a bare ``state_dict`` (the eval slice's ``.pt`` files). ``find_snapshot``
finds a run's checkpoint (``test``, ``visualize``, stage 2's frozen
stage 1), the port's ``.pt`` or the JAX package's ``.msgpack``.

``read_msgpack`` decodes what ``pemp_tpu.core.checkpoint.save`` writes
without ``flax`` or ``msgpack`` (stdlib ``struct`` and numpy): the outer
map ``{"variables": bytes, "opt_state": bytes, "epoch", "extra"}``, whose
``variables`` are the bytes of a second msgpack tree
(``{"params", "batch_stats"}``). Flax's ext types
(``flax/serialization.py``, ``_MsgpackExtType``): 1 an ndarray packed as
``(shape, dtype name, C-order bytes)``, 3 a numpy scalar packed the same
way; arrays above 2^30 bytes come as ``{"__msgpack_chunked_array__":
True, "shape", "chunks"}`` maps, and tuples and lists as ``{"0": ...,
"1": ...}`` maps. ``bfloat16`` leaves come back as torch tensors (numpy
has no bfloat16), every other array as numpy.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

CKPT = "ckpt.pt"
BEST = "bestckpt.pt"
# the lookup's suffix order: the port's own, then the JAX package's,
# then the reference's
CKPT_SUFFIXES = (".pt", ".msgpack", ".pth")

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"


def save(path: Path, model: torch.nn.Module,
         optimizer: Optional[torch.optim.Optimizer] = None, epoch: int = 0,
         extra: Optional[Dict[str, Any]] = None) -> Path:
    """Write the checkpoint atomically (a temporary file, then rename)."""
    payload = {"model": model.state_dict(),
               "optimizer": (optimizer.state_dict()
                             if optimizer is not None else {}),
               "epoch": int(epoch), "extra": extra or {}}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(payload, tmp)
    tmp.replace(path)
    return path


def load(path) -> Dict[str, Any]:
    """The payload of a checkpoint (or a bare ``state_dict``), on the CPU;
    ``path`` a file name or a file object."""
    return torch.load(path, map_location="cpu", weights_only=True)


def model_state(payload: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The model ``state_dict`` of a full checkpoint or a bare one."""
    if "model" in payload and isinstance(payload["model"], dict):
        return payload["model"]
    return payload


# --- msgpack ---------------------------------------------------------------

# fixed-width formats: first byte -> (struct format, size)
_FIXED = {0xca: (">f", 4), 0xcb: (">d", 8),
          0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
          0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8)}
# first byte -> width of the length field of str, bin, array, map, ext
_STR = {0xd9: 1, 0xda: 2, 0xdb: 4}
_BIN = {0xc4: 1, 0xc5: 2, 0xc6: 4}
_ARRAY = {0xdc: 2, 0xdd: 4}
_MAP = {0xde: 2, 0xdf: 4}
_EXT = {0xc7: 1, 0xc8: 2, 0xc9: 4}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_UINT = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    """One msgpack document in ``data``, decoded from ``pos``."""

    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, width: int) -> int:
        return struct.unpack(_UINT[width], self.take(width))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            fmt, n = _FIXED[b]
            return struct.unpack(fmt, self.take(n))[0]
        if b in _STR:
            return self.str(self.uint(_STR[b]))
        if b in _BIN:
            return bytes(self.take(self.uint(_BIN[b])))
        if b in _ARRAY:
            return self.array(self.uint(_ARRAY[b]))
        if b in _MAP:
            return self.map(self.uint(_MAP[b]))
        if b in _EXT:
            n = self.uint(_EXT[b])
            return self.ext(struct.unpack(">b", self.take(1))[0], n)
        if b in _FIXEXT:
            return self.ext(struct.unpack(">b", self.take(1))[0], _FIXEXT[b])
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if out.get(CHUNKED) is True:
            return _unchunk(out)
        if n and all(k == str(i) for i, k in enumerate(out)):
            return list(out.values())           # a flax tuple or list
        return out

    def ext(self, code: int, n: int):
        body = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, buf = _Reader(body).value()
        dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
        arr = _array(buf, dtype, tuple(shape))
        return arr if code == EXT_NDARRAY else arr[()]


def _array(buf: bytes, dtype: str, shape):
    """A C-order array of ``dtype`` (numpy's name) from ``buf``."""
    if dtype == "bfloat16":
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16
                                ).reshape(shape)
    return np.frombuffer(bytearray(buf), dtype=np.dtype(dtype)
                         ).reshape(shape)


def _unchunk(data: Dict):
    """A ``__msgpack_chunked_array__`` map -> the array it splits (flax's
    ``_unchunk``)."""
    chunks, shape = data["chunks"], tuple(data["shape"])
    if torch.is_tensor(chunks[0]):
        return torch.cat(list(chunks)).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def read_msgpack(data: bytes) -> Any:
    """Decode one msgpack document (``flax.serialization.msgpack_restore``
    without flax): maps, arrays, str, bin, ints, floats, bool, nil; flax's
    ndarray and numpy-scalar ext types; chunked arrays rejoined; flax's
    ``{"0": ..., "1": ...}`` maps back to lists."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack document")
    return out


def read_jax_checkpoint(path: Path) -> Dict[str, Any]:
    """A ``pemp_tpu`` ``.msgpack`` checkpoint: ``{"params", "batch_stats",
    "epoch", "extra"}`` (its optimizer state is not read)."""
    return jax_checkpoint(Path(path).read_bytes())


def jax_checkpoint(data: bytes) -> Dict[str, Any]:
    """``read_jax_checkpoint`` of the file's bytes."""
    payload = read_msgpack(data)
    variables = read_msgpack(payload["variables"])
    return {"params": variables["params"],
            "batch_stats": variables.get("batch_stats", {}),
            "epoch": int(payload.get("epoch", 0)),
            "extra": payload.get("extra") or {}}


# --- discovery -------------------------------------------------------------

def _search(run_dir: Path, ckpt: str) -> Optional[Path]:
    """``ckpt`` in ``run_dir``, else ``bestckpt`` then ``ckpt`` with each
    suffix of ``CKPT_SUFFIXES`` in turn."""
    names = [ckpt] if ckpt else []
    names += [f"{stem}{suf}" for stem in ("bestckpt", "ckpt")
              for suf in CKPT_SUFFIXES]
    for name in names:
        if (run_dir / name).exists():
            return run_dir / name
    return None


def find_snapshot(model_dir, tag: str, exp_id: int, ckpt: str = "") -> Path:
    """A run's checkpoint, by the JAX package's five steps
    (``pemp_tpu/utils/misc.py:34-84``):

    1. ``ckpt`` as an existing path;
    2. ``<model_dir>/<tag>/<exp_id>/<ckpt>``;
    3. ``<model_dir>/<tag>/<exp_id>/{bestckpt,ckpt}{.pt,.msgpack,.pth}``;
    4. steps 2-3 in ``<model_dir>/*/<exp_id>/``, the tags in sorted order;
    5. steps 2-3 in the runs under ``<model_dir>/<tag>``, the largest id
       first.

    Raises ``FileNotFoundError`` when there is none."""
    model_dir, tag = Path(model_dir), str(tag)
    if ckpt and Path(ckpt).exists():
        return Path(ckpt)
    if exp_id >= 0:
        found = _search(model_dir / tag / str(exp_id), ckpt)
        if found:
            return found
        for other in sorted(model_dir.glob(f"*/{exp_id}")):
            found = _search(other, ckpt)
            if found:
                return found
    tag_dir = model_dir / tag
    if tag_dir.exists():
        for rid in sorted((int(p.name) for p in tag_dir.iterdir()
                           if p.name.isdigit()), reverse=True):
            found = _search(tag_dir / str(rid), ckpt)
            if found:
                return found
    raise FileNotFoundError(
        f"No checkpoint found under {model_dir}/{tag} (exp_id={exp_id}, "
        f"ckpt='{ckpt}')")
