"""Dataset registry + loader factory (``SYNTH`` test episodes so far).

Counterpart of ``pemp_tpu/data/datasets.py`` (reference
data_kits/datasets.py). PASCAL-5i, COCO-20i and the training episodes
are not ported yet.
"""

from __future__ import annotations

from typing import List

from pemp_tpu_torch.data.loader import EpisodeLoader


def load(cfg):
    """The test episodes: returns (dataset, loader, num_classes)."""
    name = cfg.data.dataset.upper()
    if name == "SYNTH":
        from pemp_tpu_torch.data.synthetic import SyntheticDataset
        ds = SyntheticDataset(cfg, cfg.split, cfg.shot, cfg.query)
    elif name in ("PASCAL", "COCO"):
        raise NotImplementedError(
            f"The {name} loader is not ported yet; use data.dataset=SYNTH")
    else:
        raise ValueError(f"Unknown dataset '{cfg.data.dataset}'. "
                         "[PASCAL, COCO, SYNTH]")
    loader = EpisodeLoader(ds, cfg.data.test_bs,
                           num_workers=cfg.data.num_workers)
    return ds, loader, ds.num_classes


def get_val_labels(cfg, split: int) -> List[int]:
    if cfg.data.dataset.upper() == "COCO":
        return list(range(split * 20 + 1, split * 20 + 21))
    return list(range(split * 5 + 1, split * 5 + 6))
