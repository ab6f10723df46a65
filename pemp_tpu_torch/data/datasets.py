"""Dataset registry and loader factory.

Counterpart of ``pemp_tpu/data/datasets.py`` (reference
data_kits/datasets.py): ``load(cfg, mode)`` over PASCAL-5i, COCO-20i and
``SYNTH`` in the modes ``train``, ``eval_online``, ``test`` and
``visualize`` (test episodes with their sample names); the dataset root
(``data.base_dir``, else ``DEFAULT_ROOTS``, relative to the working
directory), which must exist; the split's validation classes and the
class names.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

from pemp_tpu_torch.data.loader import EpisodeLoader

MODES = ("train", "eval_online", "test", "visualize")
DEFAULT_ROOTS = {
    "PASCAL": "data/VOCdevkit/VOC2012",
    "COCO": "data/COCO",
}


def resolve_base_dir(cfg) -> str:
    """The root of ``data.dataset``'s tree ("" for ``SYNTH``); raises
    ``FileNotFoundError`` when it does not exist."""
    name = cfg.data.dataset.upper()
    if name == "SYNTH":
        return ""
    base = cfg.data.base_dir or DEFAULT_ROOTS.get(name, "")
    if not base or not Path(base).exists():
        raise FileNotFoundError(
            f"Dataset root for {name} not found at '{base}'. Set "
            f"data.base_dir=<path> (expected layout like the reference: "
            f"{DEFAULT_ROOTS.get(name)}).")
    return base


def load(cfg, mode: str = "test"):
    """Returns (dataset, loader, num_classes). ``mode``: ``train`` (batches
    of ``data.bs`` of this process's shard of the episodes, a short last
    batch dropped), ``eval_online``, ``test``
    or ``visualize`` (batches of ``data.test_bs``; ``visualize`` adds the
    sample names). ``data.base_dir`` becomes the resolved root."""
    if mode not in MODES:
        raise ValueError(f"mode '{mode}' not in {MODES}")
    train = mode == "train"
    name = cfg.data.dataset.upper()
    if name == "SYNTH":
        from pemp_tpu_torch.data.synthetic import SyntheticDataset as cls
    elif name == "PASCAL":
        from pemp_tpu_torch.data.pascal import PascalVOC as cls
    elif name == "COCO":
        from pemp_tpu_torch.data.coco import COCO20i as cls
    else:
        raise ValueError(f"Unknown dataset '{cfg.data.dataset}'. "
                         "[PASCAL, COCO, SYNTH]")
    if name != "SYNTH":
        cfg.data.base_dir = resolve_base_dir(cfg)
    ds = cls(cfg, train, cfg.split, cfg.shot, cfg.query,
             ret_name=mode == "visualize")
    # each process of a world trains on its shard of the episodes
    loader = EpisodeLoader(ds, cfg.data.bs if train else cfg.data.test_bs,
                           num_workers=cfg.data.num_workers, drop_last=train,
                           shard_by_process=train)
    return ds, loader, ds.num_classes


def get_val_labels(cfg, split: int) -> List[int]:
    if cfg.data.dataset.upper() == "COCO":
        return list(range(split * 20 + 1, split * 20 + 21))
    return list(range(split * 5 + 1, split * 5 + 6))


def get_class_name(cls: int, dataset: str) -> str:
    """A class's name: COCO's by its contiguous id, else PASCAL's (which
    ``SYNTH`` uses too)."""
    if dataset.upper() == "COCO":
        from pemp_tpu_torch.data.coco import class_name
    else:
        from pemp_tpu_torch.data.pascal import class_name
    return class_name(int(cls))
