"""Export the port's checkpoint (``.pt``), or the JAX package's
(``.msgpack``), to the reference's ``.pth`` state_dict layout.

Counterpart of ``tools/export_reference_ckpt.py``, the inverse of
``convert_reference_ckpt``, with its arguments. The checkpoint is loaded
strictly into the port's model of ``--model``, ``--backbone`` and
``--shot`` (``core/experiment.py::load_weights``: a ``.pt`` as the
trainer writes it or a bare ``state_dict``; a ``.msgpack`` through
``core/checkpoint.py::read_jax_checkpoint`` and
``utils/convert.py::state_dict_from_jax``), and the model's
``state_dict`` is written as the reference holds it (``reference_sd``):
float32 tensors under the same keys, without the batch norms' step
counters (``num_batches_tracked``), which the JAX exporter does not
write. For every family the JAX exporter covers, the keys and tensors
equal its ``export_trained`` on the same weights; stage 2 with
``vgg16`` (VGG16CM), which the JAX exporter refuses, is exported in the
port's layout (``utils/convert.py``).

Usage::

  python -m pemp_tpu_torch.tools.export_reference_ckpt \\
      --model pemp_stage1 --backbone resnet50 --ckpt bestckpt.pt \\
      --out bestckpt.pth          # or --ckpt bestckpt.msgpack
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict

import torch

from pemp_tpu_torch.core.experiment import load_weights
from pemp_tpu_torch.tools.convert_reference_ckpt import FAMILIES, build_model

SKIPPED = ("num_batches_tracked",)


def reference_sd(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s ``state_dict`` in the reference file's form: the
    tensors (detached, contiguous) under their keys, the step counters
    left out."""
    return {k: v.detach().contiguous()
            for k, v in model.state_dict().items()
            if not k.endswith(SKIPPED)}


def export(path: Path, name: str, backbone: str, shot: int
           ) -> Dict[str, torch.Tensor]:
    """The reference ``state_dict`` of the checkpoint at ``path``."""
    model = build_model(name, backbone, shot)
    load_weights(model, Path(path))
    return reference_sd(model)


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", required=True, choices=FAMILIES)
    ap.add_argument("--backbone", default="resnet50")
    ap.add_argument("--ckpt", required=True,
                    help="the port's .pt or the JAX package's .msgpack")
    ap.add_argument("--out", required=True, help="output .pth path")
    ap.add_argument("--shot", type=int, default=1)
    args = ap.parse_args(argv)
    sd = export(Path(args.ckpt), args.model, args.backbone, args.shot)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(sd, out)
    print(f"exported {args.ckpt} -> {out} ({len(sd)} tensors)")
    return out


if __name__ == "__main__":
    main()
