"""Export a model's eval forward as a ``torch.export`` serving artifact.

Counterpart of ``tools/export_serving.py``: any family's eval forward, or
the stage-1 -> stage-2 cascade, with its weights baked in, saved as one
``.pt2`` file (``torch.export.save``) and a ``<out>.json`` manifest.
``--batch poly`` exports one BATCH-POLYMORPHIC artifact (a symbolic
episode batch, ``Dim("b", min=1)``): the serving side calls it at any B
without re-exporting. Spatial sizes stay static (the resize matrices are
baked per resolution).

The artifact maps (sup_rgb [B,S,H,W,3], sup_mask [B,S,H,W,2], qry_rgb
[B,Q,H,W,3]) -> logits [B,Q,H,W,2] at input resolution (argmax = the
prediction); ``pemp_stage2`` also takes the stage-1 prior [B,Q,H,W],
``canet`` the history [B,Q,ceil(H/8),ceil(W/8),2]. RPMMs' EM starts from
the draw of a generator seeded ``EVAL_SEED``, baked in (its eval draws
the same afresh each batch); RPMMs predicts with its last pyramid output,
PFENet and PANet with their first.

The PEMP models' meta-prototype module is two graph nodes,
``pemp.mpm_assign`` and ``pemp.mpm_match`` (``ops/kernels/mpm.py``): on
the card they launch the hand-written kernels, on the CPU their plain
versions. So, unlike the JAX tool's self-contained StableHLO, the
serving side needs ``pemp_tpu_torch`` importable: ``load_serving``
registers the operators, then loads.

Usage (the card by default; ``--device cpu`` only when asked, and
without a card the tool raises)::

  python -m pemp_tpu_torch.tools.export_serving --model pemp_stage1 \\
      --backbone resnet50 --ckpt model_dir/pemp_stage1/1/bestckpt.pt \\
      --out pemp_s1.pt2 --batch poly --hw 401
  python -m pemp_tpu_torch.tools.export_serving --model cascade \\
      --s1-ckpt s1.pt --ckpt s2.pt --out cascade.pt2 --batch 8

and on the serving side::

  ep = load_serving("pemp_s1.pt2")
  logits = ep.module()(sup_rgb, sup_mask, qry_rgb)
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from pemp_tpu_torch.config import Config
from pemp_tpu_torch.core.experiment import load_weights, set_precision
from pemp_tpu_torch.device import resolve_device
from pemp_tpu_torch.entry.rpmms import EVAL_SEED
from pemp_tpu_torch.models import registry
from pemp_tpu_torch.models.pemp_stage2 import PEMPCascade
from pemp_tpu_torch.models.rpmms import pmm_mu_init
from pemp_tpu_torch.ops.kernels import mpm as _mpm_ops  # noqa: F401  (pemp::*)

MODELS = ("baseline", "pemp_stage1", "pemp_stage2", "panet", "canet",
          "rpmms", "pfenet", "cascade")
POLY_EXAMPLE_BATCH = 2      # torch specialises a traced dim of size 0 or 1
OUTPUT = "[B,Q,H,W,2] input-resolution logits (argmax=pred)"


class ServingForward(nn.Module):
    """The eval forward of ``model`` (registry family ``name``, or
    ``"cascade"`` for a ``PEMPCascade``) at input resolution ``hw``, one
    logits tensor out (``hw=None``: at feature resolution). ``extra`` is
    stage 2's prior or CaNet's history."""

    def __init__(self, name: str, model: nn.Module, hw: int):
        super().__init__()
        self.name = name
        self.model = model
        self.hw = hw
        if name == "rpmms":
            gen = torch.Generator().manual_seed(EVAL_SEED)
            c = model.layer5[0].out_channels
            device = next(model.parameters()).device
            for i, k in enumerate(model.num_pro_list):
                self.register_buffer(f"mu0_{i}",
                                     pmm_mu_init(gen, c, k, device))

    def mu_init(self) -> List[torch.Tensor]:
        return [getattr(self, f"mu0_{i}")
                for i in range(len(self.model.num_pro_list))]

    def forward(self, sup_rgb: torch.Tensor, sup_mask: torch.Tensor,
                qry_rgb: torch.Tensor,
                extra: Optional[torch.Tensor] = None) -> torch.Tensor:
        out_hw = None if self.hw is None else (self.hw, self.hw)
        args = (sup_rgb, sup_mask, qry_rgb)
        if self.name == "rpmms":
            return self.model(*args, out_hw=out_hw,
                              mu_init=self.mu_init())[-1]
        if self.name == "pfenet":
            return self.model(*args, out_hw=out_hw)[0]
        if self.name == "panet":
            return self.model(*args, out_hw=out_hw, align=False)
        if extra is not None:
            args = args + (extra,)
        return self.model(*args, out_hw=out_hw)


def input_shapes(name: str, batch: Union[int, str], shot: int, query: int,
                 hw: int) -> List[tuple]:
    """The artifact's input shapes at episode batch ``batch`` (an int, or
    a name for a symbolic batch)."""
    shapes = [(batch, shot, hw, hw, 3), (batch, shot, hw, hw, 2),
              (batch, query, hw, hw, 3)]
    if name == "pemp_stage2":
        shapes.append((batch, query, hw, hw))
    elif name == "canet":
        h8 = -(-hw // 8)
        shapes.append((batch, query, h8, h8, 2))
    return shapes


def _specs(name: str, batch: Union[int, str], shot: int, query: int, hw: int,
           device: torch.device):
    """Example inputs (zeros) and their ``dynamic_shapes``: dim 0 of each
    symbolic for ``batch == "poly"``, else every dim static."""
    poly = batch == "poly"
    example = POLY_EXAMPLE_BATCH if poly else int(batch)
    inputs = tuple(torch.zeros(s, device=device)
                   for s in input_shapes(name, example, shot, query, hw))
    if not poly:
        return inputs, None
    b = torch.export.Dim("b", min=1)
    return inputs, tuple({0: b} for _ in inputs)


def build_serving_fn(model_name: str, model: nn.Module,
                     batch: Union[int, str], shot: int, query: int, hw: int,
                     device) -> Tuple[ServingForward, tuple, Optional[tuple]]:
    """``model``'s eval forward as a module on ``device`` (eval mode,
    channels_last), its example inputs and their ``dynamic_shapes``
    (``batch`` an int, or ``"poly"`` for a symbolic batch)."""
    device = resolve_device(device)
    model = model.to(device, memory_format=torch.channels_last).eval()
    serve = ServingForward(model_name, model, hw).eval()
    return (serve, *_specs(model_name, batch, shot, query, hw, device))


def build_cascade_serving_fn(s1_model: nn.Module, s2_model: nn.Module,
                             batch: Union[int, str], shot: int, query: int,
                             hw: int, device):
    """The deployed PEMP path as one module: the frozen stage 1, its
    argmax prior on the device, stage 2 (``PEMPCascade``); inputs are
    stage 1's, both weight sets are baked in."""
    return build_serving_fn("cascade", PEMPCascade(s1_model, s2_model),
                            batch, shot, query, hw, device)


def export_serving(serve: nn.Module, inputs: tuple,
                   dynamic_shapes: Optional[tuple] = None
                   ) -> torch.export.ExportedProgram:
    """``torch.export`` of the eval forward, without grad (the
    meta-prototype module is then the two ``pemp::`` operators)."""
    with torch.no_grad():
        return torch.export.export(serve, inputs,
                                   dynamic_shapes=dynamic_shapes)


def save_serving(exported: torch.export.ExportedProgram, out,
                 manifest: Dict) -> int:
    """Write the artifact to ``out`` and the manifest, with its size in
    ``bytes``, to ``<out>.json``; returns the size. The export's example
    inputs (zeros; 10 MB at 401x401) are dropped from ``exported`` first:
    the manifest gives the shapes."""
    out = Path(out)
    exported.example_inputs = None
    torch.export.save(exported, str(out))
    size = out.stat().st_size
    Path(str(out) + ".json").write_text(
        json.dumps(dict(manifest, bytes=size), indent=2))
    return size


def artifact_manifest(model: str, backbone: str, batch: Union[int, str],
                      shot: int, query: int, hw: int, precision: str,
                      device: torch.device) -> Dict:
    """An artifact's manifest (``batch`` an int, or ``"b"`` for a
    symbolic batch)."""
    return {
        "model": model, "backbone": backbone, "batch": batch,
        "shot": shot, "query": query, "hw": hw, "precision": precision,
        "device": device.type, "torch": torch.__version__,
        "inputs": input_shapes(model, batch, shot, query, hw),
        "output": OUTPUT,
    }


def load_serving(path) -> torch.export.ExportedProgram:
    """An artifact written by ``save_serving``, the ``pemp::`` operators
    registered; with its manifest beside it, the process's matmul and
    cuDNN TF32 settings are the export's ``precision``'s."""
    manifest = Path(str(path) + ".json")
    if manifest.exists():
        set_precision(json.loads(manifest.read_text())["precision"])
    return torch.export.load(str(path))


def build_model(name: str, backbone: str, shot: int, precision: str,
                ckpt: str) -> nn.Module:
    """Registry family ``name`` at ``backbone`` and ``shot``, its weights
    from ``ckpt`` (the port's ``.pt`` or the JAX package's ``.msgpack``)."""
    cfg = Config(tag=name, shot=shot)
    cfg.net = registry.net_config(name)
    for key in ("backbone", "backbone2"):
        if hasattr(cfg.net, key):
            setattr(cfg.net, key, backbone)
    cfg.dev.precision = precision
    model = registry.build(name, cfg)
    load_weights(model, Path(ckpt))
    return model


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m pemp_tpu_torch.tools.export_serving")
    ap.add_argument("--model", required=True, choices=MODELS)
    ap.add_argument("--backbone", default="resnet50")
    ap.add_argument("--s1-ckpt", default="",
                    help="stage-1 checkpoint for --model cascade "
                         "(--ckpt is then the stage-2 checkpoint)")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", default="8",
                    help="episode batch size, or 'poly' for a "
                         "batch-polymorphic artifact (symbolic B)")
    ap.add_argument("--shot", type=int, default=1)
    ap.add_argument("--query", type=int, default=1)
    ap.add_argument("--hw", type=int, default=401)
    ap.add_argument("--precision", default="bf16", choices=["bf16", "f32"],
                    help="backbone compute dtype, as dev.precision")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    batch = "poly" if args.batch in ("poly", "sym") else int(args.batch)
    device = resolve_device(args.device)
    set_precision(args.precision)

    t0 = time.perf_counter()
    if args.model == "cascade":
        if not args.s1_ckpt:
            ap.error("--model cascade needs --s1-ckpt (stage-1 weights)")
        s1 = build_model("pemp_stage1", args.backbone, args.shot,
                         args.precision, args.s1_ckpt)
        s2 = build_model("pemp_stage2", args.backbone, args.shot,
                         args.precision, args.ckpt)
        serve, inputs, dyn = build_cascade_serving_fn(
            s1, s2, batch, args.shot, args.query, args.hw, device)
    else:
        model = build_model(args.model, args.backbone, args.shot,
                            args.precision, args.ckpt)
        serve, inputs, dyn = build_serving_fn(
            args.model, model, batch, args.shot, args.query, args.hw, device)
    exported = export_serving(serve, inputs, dyn)
    size = save_serving(exported, args.out, artifact_manifest(
        args.model, args.backbone, "b" if batch == "poly" else batch,
        args.shot, args.query, args.hw, args.precision, device))
    print(f"exported {args.model}/{args.backbone} -> {args.out} "
          f"({size / 1e6:.1f} MB, device={device.type}, "
          f"{time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
