"""Convert a reference-trained full-model checkpoint (``.pth``) into the
port's checkpoint (``.pt``), which ``test``, ``visualize`` and
``resume``-free runs load.

Counterpart of ``tools/convert_reference_ckpt.py`` (which writes the JAX
package's ``.msgpack``), for all seven families (``baseline``,
``pemp_stage1``, ``pemp_stage2``, ``panet``, ``canet``, ``rpmms``,
``pfenet``) with its arguments. The port's ``state_dict`` already has
the reference's key layout (``utils/convert.py``), so the conversion is
a strict load of the file into the port's model of ``--model``,
``--backbone`` and ``--shot`` (``verify_real_data.read_pth`` /
``load_strict``: every key present and every shape right; the batch
norms' step counters, which a reference file may lack, keep the
model's), then ``core/checkpoint.py::save`` of that model (``{"model":
state_dict, "optimizer": {}, "epoch": 0, "extra": {}}``). The inverse is
``export_reference_ckpt``; the round trip is bit-exact for every family
(``tests/test_torch_tools_ckpt.py``).

Usage::

  python -m pemp_tpu_torch.tools.convert_reference_ckpt \\
      --model pemp_stage1 --backbone resnet50 --ckpt bestckpt.pth \\
      --out bestckpt.pt
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from pemp_tpu_torch.config import Config
from pemp_tpu_torch.core import checkpoint as ckpt_lib
from pemp_tpu_torch.models import registry
from pemp_tpu_torch.tools.verify_real_data import load_strict, read_pth

FAMILIES = ("baseline", "pemp_stage1", "pemp_stage2", "panet", "canet",
            "rpmms", "pfenet")


def build_model(name: str, backbone: str, shot: int) -> torch.nn.Module:
    """The port's ``name`` model (float32, on the CPU) with ``backbone``
    as its trunk (stage 2: its CM trunk; CaNet, RPMMs and PFENet have
    their own) at ``shot``, as the JAX tool's ``_build_model``."""
    if name not in FAMILIES:
        raise ValueError(f"Unsupported model '{name}' (supported: "
                         f"{', '.join(FAMILIES)})")
    cfg = Config(tag=name, shot=shot)
    cfg.net = registry.net_config(name)
    for key in ("backbone", "backbone2"):
        if hasattr(cfg.net, key):
            setattr(cfg.net, key, backbone)
    cfg.dev.precision = "f32"
    return registry.build(name, cfg)


def convert(sd, name: str, backbone: str, shot: int) -> torch.nn.Module:
    """The port's model holding the reference ``state_dict`` ``sd``
    (strict)."""
    model = build_model(name, backbone, shot)
    load_strict(model, sd)
    return model


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", required=True, choices=FAMILIES)
    ap.add_argument("--backbone", default="resnet50")
    ap.add_argument("--ckpt", required=True, help="reference .pth")
    ap.add_argument("--out", required=True, help="the port's .pt")
    ap.add_argument("--shot", type=int, default=1)
    args = ap.parse_args(argv)
    model = convert(read_pth(Path(args.ckpt)), args.model, args.backbone,
                    args.shot)
    out = ckpt_lib.save(Path(args.out), model)
    print(f"converted {args.ckpt} -> {out}")
    return out


if __name__ == "__main__":
    main()
