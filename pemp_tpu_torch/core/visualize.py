"""The ``visualize`` command's dump for the result viewer.

Counterpart of ``pemp_tpu/core/visualize.py`` (reference
core/base_trainer.py:311-403, ``evaluate_and_save``): the model, loaded
from a run's snapshot, runs with response maps over the test stream (or
over one episode the ``p`` scope names: ``p.cls``, ``p.sup``, ``p.qry``)
and writes, per episode, the support and query images, their masks, the
binary prediction, the response map in the 6-colour palette and
``data.json`` into
``<PEMP_HTTP_STATIC or http/static>/<eid>_<ds>_<shot>shot_<tag>_s<split>
[_misc][_c<k>]/<i>_<cls>/``, which ``http/viewer.py`` serves. Only the
first episode of each batch is drawn, as in the JAX package. The query
GT may have a size of its own (PASCAL's and COCO's test protocol): the
prediction and the response map are drawn at it. File names carry the
class name with ``/`` as ``_`` (PASCAL's "tv/monitor"; the JAX package
writes it as is, into a folder that does not exist).
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from pemp_tpu_torch.parallel.step import device_batch, unpack_batch
from pemp_tpu_torch.data import datasets
from pemp_tpu_torch.device import resolve_device
from pemp_tpu_torch.ops.resize import resize_bilinear_align_corners_np

# the reference's BGR palette (base_trainer.py:352-354) as RGB
RESPONSE_COLORS = np.array([
    [25, 70, 147], [30, 116, 179], [112, 172, 207],
    [100, 11, 12], [193, 32, 38], [247, 178, 78],
], np.uint8)


def _denorm(rgb: np.ndarray, cfg) -> np.ndarray:
    """Undo the loader's normalisation with ``data.mean`` / ``data.std``."""
    mean = np.asarray(cfg.data.mean, np.float32)
    std = np.asarray(cfg.data.std, np.float32)
    return np.clip((rgb * std + mean) * 255.0, 0, 255).astype(np.uint8)


def _save(path: Path, arr: np.ndarray) -> None:
    Image.fromarray(arr).save(str(path))


def static_dir(cfg) -> Path:
    """The episode folders' parent: ``PEMP_HTTP_STATIC``, else the
    repository's ``http/static`` (where the viewer looks)."""
    root = Path(os.environ.get(
        "PEMP_HTTP_STATIC", Path(__file__).parents[2] / "http" / "static"))
    eid = cfg.exp_id if cfg.exp_id >= 0 else 0
    return root / (
        f"{eid}_{cfg.data.dataset.lower()}_{cfg.shot}shot_{cfg.tag}"
        f"_s{cfg.split}{'_misc' if cfg.p.cls > 0 else ''}"
        + (f"_c{cfg.data.one_cls}" if cfg.data.one_cls > 0 else ""))


@torch.no_grad()
def evaluate_and_save(runtime, max_episodes: int = 50) -> str:
    """Dump up to ``max_episodes`` episodes of ``runtime``'s model (its
    ``apply_visualize``: feature-resolution logits and response map) for
    the viewer; returns the folder written."""
    cfg = runtime.cfg
    http_dir = static_dir(cfg)
    ds, loader, _ = datasets.load(cfg, "visualize")
    ds.reset_sampler()
    ds.sample_tasks()
    if cfg.p.cls > 0:
        # one user-chosen episode (reference OneExampleLoader,
        # data_kits/pascal_voc.py:540-558)
        sup = [s for s in str(cfg.p.sup).split(",") if s]
        ds.sampler.tasks = [(cfg.p.cls, sup + [cfg.p.qry])]
        ds.sampler.n_episodes = 1

    device = resolve_device(cfg.dev.device)
    runtime.resolve_snapshot(required=True)
    model = runtime.build_model(cfg, device)
    runtime.logger.info(f"Model initialized from {cfg.ckpt}")

    with runtime.kernels():
        return _dump_episodes(runtime, model, ds, loader, http_dir,
                              max_episodes)


def _dump_episodes(runtime, model, ds, loader, http_dir,
                   max_episodes: int) -> str:
    cfg, device = runtime.cfg, resolve_device(runtime.cfg.dev.device)
    for i, batch in enumerate(loader):
        if i >= max_episodes or i >= len(ds.sampler.tasks):
            break
        cls = int(batch["cls"][0])
        cname = datasets.get_class_name(cls, cfg.data.dataset)
        fname = cname.replace("/", "_")
        logits, response = runtime.apply_visualize(
            model, unpack_batch(device_batch(
                batch, device, cfg.dev.compact_wire, runtime.device_keys)))
        logits = logits[0, 0].float().cpu().numpy()         # [h, w, 2]
        response = response[0, 0].cpu().numpy()             # [h, w]

        label = batch["qry_msk"][0]
        label = label.reshape(label.shape[-2:]).astype(np.float32)
        lg = resize_bilinear_align_corners_np(logits, label.shape)
        pred = lg.argmax(axis=-1).astype(np.float32)
        # the response map nearest-resized to the label's size
        ry = (np.arange(label.shape[0]) * response.shape[0]
              // label.shape[0]).clip(0, response.shape[0] - 1)
        rx = (np.arange(label.shape[1]) * response.shape[1]
              // label.shape[1]).clip(0, response.shape[1] - 1)
        color = RESPONSE_COLORS[np.clip(response[np.ix_(ry, rx)], 0, 5)]

        acc = float((pred * label).sum() * 2
                    / max(pred.sum() + label.sum(), 1e-6))
        save = http_dir / f"{i:03d}_{cls:02d}"
        save.mkdir(parents=True, exist_ok=True)
        sup_names = [str(n) for n in batch["sup_names"][0]]
        qry_name = str(batch["qry_names"][0][0])
        data = {"acc": str(round(acc, 3)), "cls_id": cls, "cls_name": cname,
                "qry": qry_name}
        if cfg.shot == 1:
            data["sup"] = sup_names[0]
        else:
            for j, n in enumerate(sup_names):
                data[f"sup{j + 1}"] = n
        (save / "data.json").write_text(json.dumps(data))

        for j, n in enumerate(sup_names):
            _save(save / f"{fname}_sup_img_{n}.jpg",
                  _denorm(batch["sup_rgb"][0, j], cfg))
            _save(save / f"{fname}_sup_msk_{n}.png",
                  (batch["sup_mask"][0, j, :, :, 0] * 255).astype(np.uint8))
        _save(save / f"{fname}_qry_img_{qry_name}.jpg",
              _denorm(batch["qry_rgb"][0, 0], cfg))
        _save(save / f"{fname}_qry_msk_{qry_name}.png",
              (label * 255).astype(np.uint8))
        _save(save / f"{fname}_qry_pred_{qry_name}.png",
              (pred * 255).astype(np.uint8))
        _save(save / f"{fname}_qry_color_{qry_name}.png", color)
        print(f"[{i:03d}][{cls:02d}] Accuracy: {acc:.3f}")

    runtime.logger.info(f"Visualization saved to {http_dir}")
    return str(http_dir)
