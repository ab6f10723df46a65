"""How ``correct`` is decided: the program's outputs against the plain
reference (``benchmark/reference``), each number beside its limit
(``benchmark/limits/<cell>.json``).

Training (``mode: train``): the reference follows the check's launches
step by step, on the same batches, weights and dropout masks (its own
generator, seeded as the program's, draws them in the program's order),
and the numbers are

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: after the first launch, the worst leaf's gap between the
  norms of the optimizer's momentum buffer (the clipped gradients plus
  weight decay of that launch's steps), over the reference's norm of
  that leaf or of the median leaf, whichever is larger;
- ``change_gap``: after the last check launch, the same of the
  parameters' change from their start;
- ``nonfinite``: non-finite losses among the window's.

Leaves whose reference momentum norm is under a thousandth of the median
leaf's are left out of the two leaf gaps (none is, at these shapes).
The mode's driver (``benchmark/drivers/<mode>.py``, ``Driver.check``)
picks the comparison; the reference is the configuration's
(``benchmark/reference/<reference>.py``).

Evaluation (``mode: eval``): a sample of the window's answers, drawn from
the seed, against the reference's for the same episodes:

- ``loss_gap``: the largest relative gap of an episode's cross entropy
  (at its GT's size, after the resize);
- ``mean_loss_gap``: the relative gap of the sample's summed cross
  entropy (the eval loss a user reads);
- ``iou_gap``: the relative gap of the sample's fg IoU, from its summed
  TP / FP / FN counts (what the mIoU is made of);
- ``nonfinite``: non-finite losses among the window's.

A cell's limits file names the numbers it is judged on: those whose
sound runs and control lie apart (PERF.md, section 6).

The reference runs after the window, once the program's state is freed,
in blocks, so that it does not set the process's memory peak.
"""

from __future__ import annotations

import json
import statistics
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import reference as references
from benchmark import traffic

ROOT = Path(__file__).resolve().parent
EXCLUDE_BELOW = 1e-3        # of the median leaf's reference momentum norm
EVAL_BLOCK = 8              # episodes a reference forward


def limits(cell: str) -> Dict[str, float]:
    return json.loads((ROOT / "limits" / f"{cell}.json").read_text())


def unpack(b: Dict) -> Dict[str, torch.Tensor]:
    """A batch in the program's wire format, as the reference computes on
    it: images and masks in float32, labels as integers."""
    out = {k: b[k].float() for k in ("sup_rgb", "sup_mask", "qry_rgb")}
    if isinstance(b["qry_msk"], torch.Tensor):
        out["qry_msk"] = b["qry_msk"].long()
    return out


def reference_model(cfg: Dict, state: Dict, device, precision: str):
    reference = references.of(cfg)
    reference.exact_f32()
    model = reference.build(cfg, device, precision)
    model.load_state_dict(state)
    return model


def train_reference(cfg: Dict, mix: Dict, pool: Dict, state: Dict,
                    seed: int, device, precision: str = "f32",
                    fault: str = "") -> Dict:
    """The check's launches on the reference: every step's loss, the
    momentum norms after the first launch and the change norms after the
    last, per leaf. ``fault="half_batch"`` (put in the program's place,
    for ``control.py``) trains each step on the first half of its batch
    alone, the loss its mean over them."""
    reference = references.of(cfg)
    model = reference_model(cfg, state, device, precision).train()
    gen = torch.Generator(device=device).manual_seed(
        traffic.sub_seed(seed, 3))
    reference.set_generator(model, gen)
    params = model.trainable()
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = reference.optimizer(cfg, params)
    k = mix["fuse_steps"]
    steps = int(mix["check"]["launches"]) * k
    out: Dict = {"losses": []}
    for step in range(steps):
        b = unpack(traffic.batch(pool, step, mix["batch"]))
        if fault == "half_batch":
            b = {key: v[:mix["batch"] // 2] for key, v in b.items()}
        elif fault:
            raise ValueError(f"no fault {fault!r}")
        out["losses"].append(float(reference.train_step(model, opt, b,
                                                        cfg)))
        if step == k - 1:
            out["momentum"] = param_norms(opt.buf)
    out["change"] = param_norms(
        {n: params[n].detach() - start[n] for n in params})
    return out


def param_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in tensors.items()}


def kept_leaves(ref: Dict) -> List[str]:
    """The leaves the two leaf gaps read: those whose reference momentum
    norm is at least ``EXCLUDE_BELOW`` of the median leaf's."""
    med = statistics.median(ref["momentum"].values())
    return [n for n, v in ref["momentum"].items()
            if v >= EXCLUDE_BELOW * med]


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
              keep: List[str]) -> float:
    med = statistics.median(ref[n] for n in keep)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in keep)


def compare_train(prog: Dict, ref: Dict) -> Dict[str, float]:
    if set(prog["momentum"]) != set(ref["momentum"]):
        raise RuntimeError("the program's and the reference's trained "
                           "leaves differ")
    keep = kept_leaves(ref)
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in
                        zip(prog["losses"], ref["losses"])),
        "grad_gap": _leaf_gap(prog["momentum"], ref["momentum"], keep),
        "change_gap": _leaf_gap(prog["change"], ref["change"], keep),
    }


def eval_picks(answers: List[Tuple], mix: Dict, seed: int
               ) -> List[Tuple[int, np.ndarray, float]]:
    """A sample of the window's answers, drawn from the seed: (pool
    episode, counts [2, 3], loss)."""
    b = mix["batch"]
    flat = [(i * b + r, counts[r], float(losses[r]))
            for i, counts, losses in answers for r in range(len(losses))]
    if not flat:
        raise RuntimeError("the window answered nothing")
    rng = np.random.default_rng(traffic.sub_seed(seed, 5))
    n = min(int(mix["check"]["episodes"]), len(flat))
    return [flat[j] for j in sorted(rng.choice(len(flat), n,
                                               replace=False))]


def eval_reference(cfg: Dict, pool: Dict, episodes: List[int],
                   state: Dict, device, precision: str = "f32"
                   ) -> Dict[int, Tuple[np.ndarray, float]]:
    """The reference's (counts, loss) of each pool episode named."""
    reference = references.of(cfg)
    model = reference_model(cfg, state, device, precision).eval()
    out = {}
    todo = sorted(set(episodes))
    with torch.no_grad():
        for lo in range(0, len(todo), EVAL_BLOCK):
            idx = todo[lo:lo + EVAL_BLOCK]
            sel = torch.tensor(idx, device=device)
            x = {k: pool[k][sel].float()
                 for k in ("sup_rgb", "sup_mask", "qry_rgb")}
            gts = [pool["qry_msk"][e] for e in idx]
            gts = [(gt if isinstance(gt, torch.Tensor)
                    else torch.from_numpy(gt)).to(device).long()
                   for gt in gts]
            out.update(zip(idx, reference.answers(model, x, gts)))
    return out


def _fg_iou(counts) -> float:
    tp, fp, fn = (float(v) for v in counts[1])
    return tp / max(tp + fp + fn, 1.0)


def compare_eval(picks: List[Tuple], ref: Dict) -> Dict[str, float]:
    loss_gap = 0.0
    losses = np.zeros(2)
    counts = np.zeros((2, 2, 3))
    for e, p_counts, loss in picks:
        r_counts, r_loss = ref[e]
        loss_gap = max(loss_gap, abs(loss - r_loss) / abs(r_loss))
        losses += (loss, r_loss)
        counts += (p_counts, r_counts)
    r_iou = _fg_iou(counts[1])
    return {"loss_gap": loss_gap,
            "mean_loss_gap": abs(losses[0] - losses[1]) / abs(losses[1]),
            "iou_gap": abs(_fg_iou(counts[0]) - r_iou) / max(r_iou, 1e-12)}


def run(driver, window, log=None) -> Dict[str, float]:
    """The cell's numbers: the driver's evidence (the program's state is
    freed by now) against the reference; ``log`` (a file) gets what was
    compared."""
    t0 = time.perf_counter()
    values = driver.check(log)
    if log is not None:
        print(f"check reference seconds {time.perf_counter() - t0}",
              file=log)
    values["nonfinite"] = float(window.nonfinite)
    return values


def judge(values: Dict[str, float], lim: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number the limits name within its limit, {name: {value,
    limit}}). The cell's limits file chooses its numbers among those its
    mode computes."""
    missing = set(lim) - set(values)
    if missing:
        raise RuntimeError(f"limits without a number: {sorted(missing)}")
    compared = {k: {"value": values[k], "limit": lim[k]} for k in lim}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in compared.values())
    return ok, compared
