"""Host input pipeline: how many host cores keep one card fed?

Counterpart of ``tools/bench_input.py``. Episodes are made on the host:
JPEG/PNG decode, scale jitter, colour jitter, the shared flip, the crop,
normalisation and collation (``data/pascal.py``, ``data/episodic.py``,
``data/transforms.py``, in ``data/loader.py``'s threads). This tool times
that pipeline alone, the port's ``PascalVOC`` and ``EpisodeLoader``, for
train (``--bs`` episodes a batch, a fresh draw a pass) and test (one
episode a batch) at each of ``--workers``: episodes/s and host-CPU ms an
episode, the decoded-image cache warm unless ``--no-cache`` (a warm
cache leaves the JPEG decode out of the timed passes; without it each
pass decodes every image it reads). It also
times the port's wire cast on the host (``parallel/step.py::
device_batch``: the f16/uint8 cast into pinned buffers and the copy,
ending in a synchronize), a cost the JAX tool's device put hides, as a
key of its own.

The host cores one card costs are its demand, ``--device-eps
train=<eps/s>,test=<eps/s>`` (no default: give the card's measured
rates, e.g. ``profile_train``'s and ``profile_eval``'s ``device_eps``),
times the CPU ms an episode at the smallest worker count.

By default it writes a miniature PASCAL tree of 375x500 JPEGs
(``make_fake_voc``: the port's copy of the tests' generator, the same
files byte for byte) into a temporary directory; ``--root`` reads a
VOCdevkit layout (``JPEGImages/``, ``Binary_map_aug/``) instead.

Usage (the card unless ``--device cpu``; without a card it raises)::

  python -m pemp_tpu_torch.tools.bench_input --device-eps train=X,test=Y \\
      [--root DIR] [--hw 401] [--episodes 300] [--workers 1,2,4] \\
      [--shot 1] [--bs 4] [--no-cache]

Output: a table per (mode, workers) and ONE JSON summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from pemp_tpu_torch.config import Config
from pemp_tpu_torch.data.loader import EpisodeLoader
from pemp_tpu_torch.data.pascal import PascalVOC
from pemp_tpu_torch.device import resolve_device
from pemp_tpu_torch.models import registry
from pemp_tpu_torch.parallel.step import device_batch

CAST_ROUNDS = 5


def fake_voc(root: Path, per_class: int = 3, classes=range(1, 21),
             seed: int = 0, size=(48, 64), smooth: bool = False,
             quality=None) -> None:
    """A miniature VOC tree under ``root`` (``JPEGImages/``,
    ``Binary_map_aug/{train,val}/<cls>/`` masks, ``<cls>.txt`` lists):
    the generator of ``tests/fixtures.py::make_fake_voc``, the same files
    byte for byte for the same arguments. ``size`` is ``(h, w)`` or
    ``(cls, i) -> (h, w)``; ``smooth`` upsamples low-resolution noise
    (photo-like JPEG entropy); ``quality`` is the JPEG quality (None:
    PIL's default). The foreground box is rows [h/5, 3h/5), columns
    [w/5, 13w/20)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    (root / "JPEGImages").mkdir(parents=True, exist_ok=True)
    for subset in ("train", "val"):
        for cls in classes:
            cdir = root / "Binary_map_aug" / subset / str(cls)
            cdir.mkdir(parents=True, exist_ok=True)
            names = []
            for i in range(per_class):
                name = f"{subset}_{cls:02d}_{i}"
                names.append(name)
                h, w = size(cls, i) if callable(size) else size
                if smooth:
                    low = (rng.rand(24, 32, 3) * 255).astype(np.uint8)
                    img = np.asarray(Image.fromarray(low).resize(
                        (w, h), Image.BILINEAR))
                else:
                    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
                kw = {} if quality is None else {"quality": quality}
                Image.fromarray(img).save(
                    root / "JPEGImages" / f"{name}.jpg", **kw)
                mask = np.zeros((h, w), np.uint8)
                mask[h // 5:3 * h // 5, w // 5:13 * w // 20] = 255
                Image.fromarray(mask).save(cdir / f"{name}.png")
            (root / "Binary_map_aug" / subset / f"{cls}.txt").write_text(
                "\n".join(names) + "\n")


def make_fake_voc(root: Path, per_class: int = 4) -> None:
    """The tool's default tree: PASCAL's typical 375x500, photo-like
    JPEGs at quality 90."""
    fake_voc(root, per_class=per_class, size=(375, 500), smooth=True,
             quality=90)


def make_config(root: Path, hw: int, episodes: int, cache: bool) -> Config:
    cfg = Config(tag="pemp_stage1")
    cfg.net = registry.net_config("pemp_stage1")
    cfg.data.dataset = "PASCAL"
    cfg.data.base_dir = str(root)
    cfg.data.height = cfg.data.width = hw
    cfg.data.train_n = episodes
    cfg.data.test_n = episodes
    cfg.data.cache = cache
    return cfg


def run_pass(ds, bs: int, workers: int, keep_first: bool = False):
    """Drain one ``EpisodeLoader`` pass over ``ds``'s tasks: (episodes,
    wall s, process CPU s, the first batch when ``keep_first``)."""
    loader = EpisodeLoader(ds, bs, num_workers=workers, prefetch=2)
    n, first = 0, None
    t0, c0 = time.perf_counter(), time.process_time()
    for batch in loader:
        if keep_first and first is None:
            first = batch
        n += int(np.shape(batch["qry_rgb"])[0])
    return n, time.perf_counter() - t0, time.process_time() - c0, first


def wire_cast_ms(batch: Dict, device: torch.device) -> float:
    """Host ms an episode of ``device_batch`` (compact wire) on ``batch``,
    ending in a synchronize on the card; the median of ``CAST_ROUNDS``
    after one warm call."""
    episodes = int(np.shape(batch["qry_rgb"])[0])

    def cast():
        device_batch(batch, device, compact_wire=True)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    cast()
    samples = []
    for _ in range(CAST_ROUNDS):
        t0 = time.perf_counter()
        cast()
        samples.append(time.perf_counter() - t0)
    return float(np.median(samples)) * 1e3 / episodes


def parse_demand(text: str) -> Dict[str, float]:
    """``train=X,test=Y`` -> {"train": X, "test": Y} (episodes/s)."""
    out = {}
    for part in text.split(","):
        key, _, value = part.partition("=")
        if key.strip() not in ("train", "test") or not value:
            raise ValueError(f"--device-eps wants train=<eps/s>,test=<eps/s>,"
                             f" got {text!r}")
        out[key.strip()] = float(value)
    return out


def bench(root: Path, args, device: torch.device,
          synthetic: bool) -> Dict:
    cfg = make_config(root, args.hw, args.episodes, not args.no_cache)
    demand = parse_demand(args.device_eps)
    worker_list = [int(w) for w in args.workers.split(",")]
    results, cast = [], {}
    print(f"# input pipeline @ {args.hw}x{args.hw}, shot={args.shot}, "
          f"bs={args.bs}, {args.episodes} episodes/pass, "
          f"cache={'on' if cfg.data.cache else 'off'}, "
          f"nproc={os.cpu_count()}")
    print(f"{'mode':8} {'workers':>7} {'eps/s':>8} {'ms/ep wall':>11} "
          f"{'ms/ep cpu':>10}")
    for train in (True, False):
        mode = "train" if train else "test"
        bs = args.bs if train else 1
        ds = PascalVOC(cfg, train=train, split=0, shot=args.shot, query=1)
        ds.sample_tasks()
        if cfg.data.cache:      # warm the decoded-image cache
            run_pass(ds, bs, workers=max(worker_list))
        for w in worker_list:
            if train:
                ds.sample_tasks()   # a fresh epoch draw, as the trainer
            n, wall, cpu, first = run_pass(ds, bs, w, keep_first=True)
            results.append({"mode": mode, "workers": w,
                            "eps_per_s": n / wall,
                            "ms_per_ep_wall": 1e3 * wall / n,
                            "ms_per_ep_cpu": 1e3 * cpu / n})
            r = results[-1]
            print(f"{mode:8} {w:>7} {r['eps_per_s']:>8.1f} "
                  f"{r['ms_per_ep_wall']:>11.2f} {r['ms_per_ep_cpu']:>10.2f}")
        cast[mode] = wire_cast_ms(first, device)
    w_min = min(worker_list)
    base = {r["mode"]: r["ms_per_ep_cpu"] for r in results
            if r["workers"] == w_min}
    return {"metric": "input_pipeline_cores_per_card",
            "cores": {m: demand[m] * base[m] / 1e3
                      for m in base if m in demand},
            "ms_per_episode_cpu": base, "results": results,
            "wire_cast_ms_per_episode": cast,
            "device_eps": demand, "device": (
                torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu"),
            "workers_measured_at": w_min,
            "decoded_image_cache": cfg.data.cache,
            "synthetic_tree": synthetic}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default="", help="a VOCdevkit-layout dir; "
                    "default writes a miniature tree")
    ap.add_argument("--hw", type=int, default=401)
    ap.add_argument("--episodes", type=int, default=300)
    ap.add_argument("--workers", default="1,2,4")
    ap.add_argument("--shot", type=int, default=1)
    ap.add_argument("--bs", type=int, default=4)
    ap.add_argument("--no-cache", action="store_true",
                    help="no decoded-image cache (data.cache=False)")
    ap.add_argument("--device-eps", required=True,
                    help="one card's demand, train=<eps/s>,test=<eps/s>")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never a fallback")
    args = ap.parse_args(argv)
    parse_demand(args.device_eps)
    device = resolve_device(args.device)
    tmp: Optional[tempfile.TemporaryDirectory] = None
    try:
        if args.root:
            root = Path(args.root)
        else:
            tmp = tempfile.TemporaryDirectory(prefix="pemp_bench_voc_")
            root = Path(tmp.name)
            make_fake_voc(root)
        summary = bench(root, args, device, not args.root)
    finally:
        if tmp is not None:
            tmp.cleanup()
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
