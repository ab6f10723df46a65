"""The real-data checklist, in dependency order, for the day data lands.

Counterpart of ``tools/verify_real_data.py``: the same five phases,
statuses, published table, tolerance, checkpoint naming and arguments,
run through the port:

  1. inventory   - what is on disk (datasets, backbone and trained .pth)
  2. goldens     - the reference's episode triples (reference
                   data_kits/pascal_voc_test.py:59-75, coco_test.py:57-73)
                   against the port's seeded ``PascalVOC``/``COCO20i``
  3. rasterizer  - the port's ``data/native/coco_mask.cpp`` (through
                   ``data/coco_index.py``) against pycocotools on real
                   annotations, bit for bit, when pycocotools imports
  4. convert     - the torchvision backbone files load; each trained
                   reference ``.pth`` loads into the port's model with
                   ``strict=True`` (the port's ``state_dict`` layout is
                   the reference's, ``utils/convert.py``), and its round
                   trip ``state_dict`` -> ``.pth`` -> model is bit-exact
                   (the JAX tool's msgpack round trip has no counterpart:
                   the port reads the ``.pth`` itself)
  5. miou        - the 5-round x 1000-episode protocol per (family,
                   split, shot, dataset) against the published tables,
                   PASS iff within +-0.2 points (BASELINE.md)

Phase 5 is a dry run by default (hours of the card): the command matrix
is printed, as ``python -m pemp_tpu_torch.entry.<family> test with ...``.
``--eval`` runs it: each trained ``.pth`` is placed as
``<model_dir>/<family>/101/bestckpt.pth`` (stage 2's stage 1 as
``<model_dir>/pemp_stage1/100/``, wired by ``s1.id=100``), each command
runs with ``exp_id=101`` and its mIoU is parsed from what it prints; a
crash is a FAIL of that row, not an abort.

Usage (the card unless ``--device cpu``, which the planned commands then
get as ``dev.device=cpu``; without a card it raises)::

  python -m pemp_tpu_torch.tools.verify_real_data        # 1-4 + the plan
  python -m pemp_tpu_torch.tools.verify_real_data --eval # + phase 5
  python -m pemp_tpu_torch.tools.verify_real_data --ckpt-dir ckpts \\
      --families pemp_stage1,pemp_stage2 --splits 0 --shots 1

Trained-checkpoint naming convention in --ckpt-dir:
  <family>_<dataset>_split<k>_shot<s>.pth     e.g.
  pemp_stage1_pascal_split0_shot1.pth (PEMP needs stage1 AND stage2).
"""

from __future__ import annotations

import argparse
import math
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from pemp_tpu_torch.device import resolve_device

ROOT = Path(__file__).resolve().parents[2]

OK, FAIL, SKIP = "OK", "FAIL", "SKIP"

# Published mIoU tables, reference README.md:139-155 (ResNet-50).
# "pemp" rows are the deployed stage-1 -> stage-2 cascade.
PUBLISHED = {
    ("pascal", "baseline", 1): [45.48, 59.97, 51.35, 43.31],
    ("pascal", "rpmms", 1): [53.86, 66.45, 52.76, 51.31],
    ("pascal", "pemp", 1): [55.74, 65.88, 54.12, 50.34],
    ("pascal", "baseline", 5): [52.47, 66.31, 59.85, 51.02],
    ("pascal", "rpmms", 5): [56.28, 67.34, 54.52, 51.00],
    ("pascal", "pemp", 5): [58.59, 69.10, 60.31, 53.01],
    ("coco", "rpmms", 1): [29.53, 36.82, 28.94, 27.02],
    ("coco", "pemp", 1): [29.28, 34.09, 29.64, 30.36],
    ("coco", "rpmms", 5): [33.82, 41.96, 32.99, 33.33],
    ("coco", "pemp", 5): [39.08, 44.59, 39.54, 41.42],
}
TOLERANCE = 0.2         # BASELINE.md north star: within 0.2 mIoU points

# Golden episode triples (class, support names, query names): the
# reference's reproducibility gate values.
PASCAL_GOLDEN_FIRST = (5, ["2010_001367"], ["2009_004324"])
COCO_GOLDEN_FIRST_5 = [
    (19, [69914], [581501]),
    (6, [35594], [53345]),
    (11, [187348], [143445]),
    (6, [457217], [315352]),
    (12, [177489], [85803]),
]

BACKBONE_PTH = ("vgg16-397923af.pth", "resnet50-19c8e357.pth",
                "resnet101-5d3b4d8f.pth", "resnet50_v2.pth")
CKPT_NAME = re.compile(r"(\w+?)_(pascal|coco)_split(\d)_shot(\d)")
S1_RUN, RUN = 100, 101


def _cfg(dataset: str, root: Path, split=0, shot=1, query=1,
         family="baseline"):
    from pemp_tpu_torch.config import Config
    from pemp_tpu_torch.models import registry
    cfg = Config(tag=family, split=split, shot=shot, query=query)
    cfg.net = registry.net_config(family)
    cfg.data.test_n = 1000
    if dataset == "coco":
        cfg.data.dataset = "COCO"
        cfg.data.base_dir = str(root / "COCO")
    else:
        cfg.data.base_dir = str(root / "VOCdevkit" / "VOC2012")
    return cfg


# ---------------------------------------------------------------- phases
def phase_inventory(root: Path):
    found = {
        "pascal": (root / "VOCdevkit" / "VOC2012"
                   / "Binary_map_aug").exists(),
        "coco": (root / "COCO" / "annotations").exists(),
    }
    for name in BACKBONE_PTH:
        found[name] = (root / name).exists()
    detail = ", ".join(f"{k}={'yes' if v else 'NO'}"
                       for k, v in found.items())
    status = OK if any(found.values()) else SKIP
    return status, detail, found


def phase_goldens(root: Path, found):
    """The seeded samplers' first episodes against the reference's."""
    results = []
    if found["pascal"]:
        from pemp_tpu_torch.data.pascal import PascalVOC
        ds = PascalVOC(_cfg("pascal", root), train=False, split=0,
                       shot=1, query=1)
        ds.reset_sampler()
        ds.sample_tasks()
        cls, names = ds.sampler.tasks[0]
        got = (cls, list(names[:1]), list(names[1:]))
        if got != PASCAL_GOLDEN_FIRST:
            return FAIL, (f"PASCAL golden episode mismatch: got {got}, "
                          f"want {PASCAL_GOLDEN_FIRST}")
        results.append("pascal golden ok")
    if found["coco"]:
        from pemp_tpu_torch.data.coco import COCO20i
        ds = COCO20i(_cfg("coco", root), train=False, split=0,
                     shot=1, query=1)
        ds.reset_sampler()
        ds.sample_tasks()
        for i, want in enumerate(COCO_GOLDEN_FIRST_5):
            cls, names = ds.sampler.tasks[i]
            got = (cls, list(names[:1]), list(names[1:]))
            if got != want:
                return FAIL, (f"COCO golden episode {i} mismatch: "
                              f"got {got}, want {want}")
        results.append("coco goldens ok")
    if not results:
        return SKIP, "no dataset on disk"
    return OK, "; ".join(results)


def phase_rasterizer(root: Path, found, n=500, seed=0):
    """The port's rasterizer against the pycocotools binary, bit for bit,
    on ``n`` sampled real annotations (reference data_kits/coco.py:
    240-270)."""
    if not found["coco"]:
        return SKIP, "no COCO on disk"
    try:
        from pycocotools.coco import COCO as PyCOCO
    except ImportError:
        return SKIP, "pycocotools not installed in this image"
    import numpy as np

    from pemp_tpu_torch.data.coco_index import COCOIndex

    ann_file = str(root / "COCO" / "annotations"
                   / "instances_train2014.json")
    ours, theirs = COCOIndex(ann_file), PyCOCO(ann_file)
    rng = np.random.RandomState(seed)
    ann_ids = theirs.getAnnIds()
    sample = rng.choice(len(ann_ids), size=min(n, len(ann_ids)),
                        replace=False)
    for i in sample:
        ann = theirs.loadAnns([ann_ids[i]])[0]
        a = ours.annToMask(ann)
        b = theirs.annToMask(ann)
        if not np.array_equal(a.astype(np.uint8), b.astype(np.uint8)):
            return FAIL, (f"rasterizer mismatch on ann {ann['id']} "
                          f"(img {ann['image_id']}): "
                          f"{int((a != b).sum())} px differ")
    return OK, f"{len(sample)} annotations bit-identical to pycocotools"


def read_pth(path: Path) -> Dict[str, torch.Tensor]:
    """A reference ``.pth``'s ``state_dict`` (a ``state_dict`` or
    ``model`` entry unwrapped)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(sd.get(key), dict):
            return sd[key]
    return sd


def family_model(family: str, shot: int) -> torch.nn.Module:
    """The port's registry model of ``family`` at ``shot``, ResNet-50 (the
    published tables' trunk), on the CPU."""
    from pemp_tpu_torch.config import Config
    from pemp_tpu_torch.models import registry
    cfg = Config(tag=family, shot=shot)
    cfg.net = registry.net_config(family)
    for key in ("backbone", "backbone2"):
        if hasattr(cfg.net, key):
            setattr(cfg.net, key, "resnet50")
    cfg.dev.precision = "f32"
    return registry.build(family, cfg)


def load_strict(model: torch.nn.Module, sd: Dict[str, torch.Tensor]):
    """``sd`` into ``model`` with ``strict=True``; the BNs' integer step
    counters, which a file written without them lacks, keep the model's
    (they count steps and hold no weight)."""
    counters = {k: v for k, v in model.state_dict().items()
                if k.endswith("num_batches_tracked") and k not in sd}
    model.load_state_dict({**sd, **counters}, strict=True)


def roundtrip(pth: Path, family: str, shot: int) -> List[str]:
    """Load ``pth`` into the port's model (strict), write the model's
    ``state_dict`` to a ``.pth``, load that into a fresh model (strict);
    returns the keys whose tensors differ from the file's."""
    want = read_pth(pth)
    model = family_model(family, shot)
    load_strict(model, want)
    with tempfile.TemporaryDirectory() as td:
        back = Path(td) / "back.pth"
        torch.save(model.state_dict(), back)
        fresh = family_model(family, shot)
        load_strict(fresh, read_pth(back))
    got = fresh.state_dict()
    return [k for k, v in want.items()
            if not (got[k].dtype == v.dtype and torch.equal(got[k], v))]


def phase_convert(root: Path, found, ckpt_dir: Optional[Path]):
    """The backbone files load; each trained checkpoint of the naming
    convention loads into the port's model (strict) and round-trips
    bit-exactly."""
    notes = []
    did = False
    for name in BACKBONE_PTH:
        if not found.get(name):
            continue
        did = True
        notes.append(f"{name}: {len(read_pth(root / name))} tensors load")
    if ckpt_dir and ckpt_dir.is_dir():
        for pth in sorted(ckpt_dir.glob("*.pth")):
            m = CKPT_NAME.match(pth.stem)
            if not m:
                notes.append(f"{pth.name}: SKIP (name convention)")
                continue
            did = True
            bad = roundtrip(pth, m.group(1), int(m.group(4)))
            if bad:
                return FAIL, (f"{pth.name}: round-trip differs on "
                              f"{len(bad)} tensors: {bad[:4]}")
            notes.append(f"{pth.name}: strict load, round-trip bit-exact")
    if not did:
        return SKIP, "no .pth files on disk"
    return OK, "; ".join(notes)


def miou_plan(root: Path, ckpt_dir: Optional[Path], families, splits,
              shots, datasets, model_dir: Path, device: str = "cuda",
              overrides: Sequence[str] = ()) -> List[Dict]:
    """The (family, dataset, split, shot) command matrix; each row
    carries its entry command and the published target (None where the
    table has no row)."""
    plan = []
    for ds in datasets:
        for fam in families:
            table_key = "pemp" if fam == "pemp_stage2" else fam
            for shot in shots:
                pub = PUBLISHED.get((ds, table_key, shot))
                for split in splits:
                    ck, s1ck = None, None
                    if ckpt_dir:
                        c = ckpt_dir / (f"{fam}_{ds}_split{split}"
                                        f"_shot{shot}.pth")
                        ck = c if c.exists() else None
                        if fam == "pemp_stage2":
                            c1 = ckpt_dir / (f"pemp_stage1_{ds}_split"
                                             f"{split}_shot{shot}.pth")
                            s1ck = c1 if c1.exists() else None
                    data_over = ["data.dataset=COCO",
                                 f"data.base_dir={root / 'COCO'}"] \
                        if ds == "coco" else \
                        [f"data.base_dir={root / 'VOCdevkit' / 'VOC2012'}"]
                    # stage 2 is a cascade: the frozen stage-1 prior
                    # comes from run s1.id (reference entry/pemp_stage2.py)
                    s1_over = [f"s1.id={S1_RUN}"] if fam == "pemp_stage2" \
                        else []
                    dev_over = ["dev.device=cpu"] if device == "cpu" else []
                    cmd = [sys.executable, "-m",
                           f"pemp_tpu_torch.entry.{fam}", "test",
                           "with", f"split={split}", f"shot={shot}",
                           "data.test_n=1000", "te.epochs=5",
                           f"g.model_dir={model_dir}",
                           *data_over, *s1_over, *dev_over, *overrides,
                           "-u"]
                    plan.append({"family": fam, "dataset": ds,
                                 "split": split, "shot": shot,
                                 "published": (pub[split] if pub else
                                               None),
                                 "ckpt": ck, "s1_ckpt": s1ck,
                                 "cmd": cmd})
    return plan


def parse_miou(text: str) -> Optional[float]:
    """The mIoU (points) of a ``test`` run's summary line ("Loss: ...,
    mIoU: 55.74, ..."), the last one printed; None without one."""
    found = re.findall(r"mIoU: (\d+\.\d+)", text)
    return float(found[-1]) if found else None


def place(pth: Path, model_dir: Path, family: str, run_id: int) -> Path:
    """``pth`` as run ``run_id``'s best snapshot of ``family``."""
    run_dir = model_dir / family / str(run_id)
    run_dir.mkdir(parents=True, exist_ok=True)
    return Path(shutil.copyfile(pth, run_dir / "bestckpt.pth"))


def run_row(cmd: Sequence[str], timeout: Optional[float] = None
            ) -> Tuple[int, Optional[float], str]:
    """One planned command from the repo root: (exit code, parsed mIoU,
    the tail of its output)."""
    r = subprocess.run(list(cmd), cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout)
    out = r.stdout + r.stderr
    return r.returncode, parse_miou(out), out[-2000:]


def phase_miou(root: Path, ckpt_dir, families, splits, shots, datasets,
               run_eval: bool, device: str = "cuda",
               overrides: Sequence[str] = ()):
    with tempfile.TemporaryDirectory(prefix="verify_miou_") as td:
        return _phase_miou(root, ckpt_dir, families, splits, shots,
                           datasets, run_eval, Path(td), device, overrides)


def _phase_miou(root, ckpt_dir, families, splits, shots, datasets,
                run_eval, model_dir, device, overrides):
    plan = miou_plan(root, ckpt_dir, families, splits, shots, datasets,
                     model_dir, device, overrides)
    if not run_eval:
        print("\n--- phase 5 plan (run with --eval to execute) ---")
        for p in plan:
            tgt = (f"target {p['published']}±{TOLERANCE}"
                   if p["published"] is not None else "no published row")
            ck = p["ckpt"].name if p["ckpt"] else "<needs trained .pth>"
            print(f"  [{p['dataset']}/{p['family']} split{p['split']} "
                  f"shot{p['shot']}] ckpt={ck} {tgt}")
            print("    " + " ".join(str(c) for c in p["cmd"])
                  + f" exp_id={RUN}")
        return SKIP, f"dry run: {len(plan)} protocol rows printed"

    rows, failures = [], []
    for p in plan:
        if p["ckpt"] is None:
            rows.append((p, None, "no checkpoint"))
            continue
        if p["family"] == "pemp_stage2":
            if p["s1_ckpt"] is None:
                rows.append((p, None, "no stage-1 checkpoint"))
                continue
            place(p["s1_ckpt"], model_dir, "pemp_stage1", S1_RUN)
        place(p["ckpt"], model_dir, p["family"], RUN)
        name = f"{p['family']} split{p['split']} shot{p['shot']}"
        try:
            rc, got, _ = run_row(p["cmd"] + [f"exp_id={RUN}"])
        except (OSError, subprocess.SubprocessError) as e:
            failures.append(f"{name}: eval failed ({type(e).__name__})")
            continue
        if rc != 0 or got is None:
            failures.append(f"{name}: eval failed (rc={rc})")
            continue
        rows.append((p, got, None))
        if p["published"] is not None \
                and abs(got - p["published"]) > TOLERANCE:
            failures.append(
                f"{p['dataset']}/{name}: {got:.2f} vs published "
                f"{p['published']:.2f} (> ±{TOLERANCE})")

    print("\n--- phase 5 results ---")
    for p, got, note in rows:
        tgt = p["published"]
        verdict = ("--" if got is None or tgt is None else
                   "PASS" if abs(got - tgt) <= TOLERANCE else "FAIL")
        print(f"  [{p['dataset']}/{p['family']} split{p['split']} "
              f"shot{p['shot']}] got={got} published={tgt} {verdict} "
              f"{note or ''}")
    if failures:
        return FAIL, "; ".join(failures)
    done = [r for r in rows if r[1] is not None and math.isfinite(r[1])]
    if not done:
        return SKIP, "no trained checkpoints to evaluate"
    return OK, f"{len(done)} protocol rows within ±{TOLERANCE}"


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Real-data closure checklist (see module docstring)")
    ap.add_argument("--data-root", default=str(ROOT / "data"))
    ap.add_argument("--ckpt-dir", default=None,
                    help="reference-trained .pth files "
                         "(<family>_<dataset>_split<k>_shot<s>.pth)")
    ap.add_argument("--families", default="baseline,rpmms,pemp_stage1,"
                                          "pemp_stage2")
    ap.add_argument("--splits", default="0,1,2,3")
    ap.add_argument("--shots", default="1,5")
    ap.add_argument("--datasets", default="pascal,coco")
    ap.add_argument("--rasterizer-n", type=int, default=500)
    ap.add_argument("--eval", action="store_true",
                    help="run the 5-round mIoU protocol (hours of the "
                         "card); default prints the plan")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never a fallback")
    args = ap.parse_args(argv)
    device = resolve_device(args.device).type

    root = Path(args.data_root)
    ckpt_dir = Path(args.ckpt_dir) if args.ckpt_dir else None
    families = args.families.split(",")
    splits = [int(s) for s in args.splits.split(",")]
    shots = [int(s) for s in args.shots.split(",")]
    datasets = args.datasets.split(",")

    results = []
    status, detail, found = phase_inventory(root)
    results.append(("1 inventory", status, detail))
    for name, fn in (
        ("2 goldens", lambda: phase_goldens(root, found)),
        ("3 rasterizer", lambda: phase_rasterizer(root, found,
                                                  args.rasterizer_n)),
        ("4 convert", lambda: phase_convert(root, found, ckpt_dir)),
        ("5 miou", lambda: phase_miou(root, ckpt_dir, families, splits,
                                      shots, datasets, args.eval,
                                      device)),
    ):
        try:
            st, det = fn()
        except Exception as e:        # a crash is a FAIL, not an abort
            st, det = FAIL, f"{type(e).__name__}: {e}"
        results.append((name, st, det))

    print("\n=== real-data closure checklist ===")
    failed = False
    for name, st, det in results:
        print(f"  [{st:4s}] {name}: {det}")
        failed |= st == FAIL
    print("=== " + ("FAIL" if failed else "ok (skips are env gaps, "
                    "not failures)") + " ===", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
