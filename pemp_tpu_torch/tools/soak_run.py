"""SIGTERM / resume drill on the stage-1 launch preset.

Counterpart of ``tools/soak_run.sh``: a SYNTH run through the preset's
defaults (``pemp_tpu_torch/scripts/pemp_stage1.sh train cuda``: fused
launches of 8 steps, the device prefetcher, observers on), stopped by a
SIGTERM once the run's records reach a target epoch, then resumed to the
end:

- phase 1 launches the preset with the JAX script's common arguments
  (``split=0 data.dataset=SYNTH data.train_n=<train_n> data.test_n=100
  data.num_workers=4 g.model_dir=<model_dir> g.mongodb=True``), polls
  ``<model_dir>/pemp_stage1/*/metrics.json`` every ``--poll`` seconds
  and sends SIGTERM to that one process once ``train_loss`` holds
  ``sigterm_epoch`` epochs. The trainer's ``GracefulStop`` stops at the
  next step or chunk boundary and exits 0 with a snapshot of the last
  whole epoch;
- phase 2 resumes the run (``resume=True exp_id=1``) to completion and
  its chained test.

Both waits for a phase's exit are bounded by multiples of phase 1's
own pace (``limits``): a stop or a resume that never ends is killed and
gives a non-zero exit code instead of hanging the drill.

Both phases write ``<model_dir>/soak_train.log``. The last line is
``SOAK_SUMMARY {...}`` with the JAX script's keys (``summarize``), the
two exit codes ``rc1``/``rc2`` and where the stop landed (``stop``: the
epoch, the steps of it taken, the fused chunks they make).

Usage (the card unless ``--device cpu``)::

  python -m pemp_tpu_torch.tools.soak_run [model_dir] [train_n] \\
      [sigterm_epoch] [--poll 20]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[2]
PRESET = ROOT / "pemp_tpu_torch" / "scripts" / "pemp_stage1.sh"
TAG = "pemp_stage1"
STOP_LINE = re.compile(r"Graceful stop inside epoch (\d+) after (\d+) steps "
                       r"\(fuse_steps (\d+)\)")


def common_args(model_dir: Path, train_n: int) -> List[str]:
    """The JAX script's ``COMMON`` arguments."""
    return ["split=0", "data.dataset=SYNTH", f"data.train_n={train_n}",
            "data.test_n=100", "data.num_workers=4",
            f"g.model_dir={model_dir}", "g.mongodb=True"]


def runs(model_dir: Path) -> List[Path]:
    """The preset's run folders' ``metrics.json``, oldest run first."""
    found = Path(model_dir).glob(f"{TAG}/*/metrics.json")
    return sorted(found, key=lambda p: int(p.parent.name)
                  if p.parent.name.isdigit() else -1)


def epochs_done(model_dir: Path) -> int:
    """Epochs the newest run has recorded (0 while none, or while its
    ``metrics.json`` is being rewritten)."""
    ms = runs(model_dir)
    if not ms:
        return 0
    try:
        return len(json.loads(ms[-1].read_text()).get("train_loss", []))
    except (OSError, json.JSONDecodeError):
        return 0


def stop_point(text: str) -> Optional[Dict]:
    """Where the graceful stop landed, from the trainer's log line: the
    epoch, the steps of it taken and the fused chunks they make."""
    m = STOP_LINE.search(text)
    if m is None:
        return None
    epoch, steps, k = (int(g) for g in m.groups())
    return {"epoch": epoch, "steps": steps, "fuse_steps": k,
            "chunks": math.ceil(steps / k)}


def summarize(model_dir, log) -> Dict:
    """The JAX script's summary of the first run's records and the log
    text of both phases (``tools/soak_run.sh:66-84``)."""
    ms = runs(Path(model_dir))
    doc = json.loads(ms[0].read_text()) if ms else {}
    tl = doc.get("train_loss", [])
    epochs = [s for s, _ in tl]
    dup = sorted({e for e in epochs if epochs.count(e) > 1})
    miou = doc.get("val_mIoU", doc.get("mIoU", []))
    txt = Path(log).read_text()
    return {
        "epochs_recorded": len(tl),
        "duplicate_epochs": dup,    # must be []: the resume replays the
        #                             interrupted epoch once
        "first_loss": tl[0][1] if tl else None,
        "last_loss": tl[-1][1] if tl else None,
        "best_mIoU": max((v for _, v in miou), default=None),
        "watchdog_events": txt.count("WATCHDOG"),
        "wedge_retries": txt.count("retrying in a fresh process"),
        "final_test": bool(re.search(r"Loss: [\d.]+, mIoU: [\d.]+", txt)),
    }


@contextmanager
def launched(device: str, args: List[str], log):
    """The preset's ``train`` as one process (the script execs the entry,
    so its PID is the trainer's), killed if it outlives the block."""
    env = dict(os.environ, PYTHON=sys.executable)
    proc = subprocess.Popen(["bash", str(PRESET), "train", device, *args],
                            stdout=log, stderr=subprocess.STDOUT, env=env)
    try:
        yield proc
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# a wait's limit: GRACE times phase 1's seconds an epoch for each epoch
# it has left (a stop: one; a resume: those left, the one it replays and
# its chained test), and never under FLOOR_S
GRACE, FLOOR_S = 4.0, 120.0


def total_epochs(model_dir: Path) -> int:
    """``tr.total_epochs`` of the first run's ``config.json`` (0 while
    there is none)."""
    ms = runs(model_dir)
    try:
        cfg = json.loads((ms[0].parent / "config.json").read_text())
        return int(cfg["tr.total_epochs"])
    except (IndexError, OSError, KeyError, ValueError):
        return 0


def limits(seconds: float, epochs: int, total: int) -> Tuple[float, float]:
    """The seconds phase 1 may take to stop after its SIGTERM and phase 2
    to end, from phase 1's ``seconds`` for its first ``epochs`` epochs of
    ``total``."""
    pace = seconds / max(epochs, 1)
    left = max(total - epochs, 0) + 2
    return (max(FLOOR_S, GRACE * pace), max(FLOOR_S, GRACE * pace * left))


def waited(proc: subprocess.Popen, seconds: float) -> int:
    """``proc``'s exit code, or, once ``seconds`` have passed, that of its
    kill (negative)."""
    try:
        return proc.wait(timeout=seconds)
    except subprocess.TimeoutExpired:
        print(f"soak: {proc.pid} still running after {seconds:.0f} s - "
              "killed", file=sys.stderr, flush=True)
        proc.kill()
        return proc.wait()


def tail(path: Path, n: int) -> str:
    return "\n".join(path.read_text().splitlines()[-n:])


def drill(model_dir: Path, train_n: int, sigterm_epoch: int, poll: float,
          device: str = "cuda", overrides=()) -> Dict:
    """Both phases, ``overrides`` (``k=v``) after the common arguments;
    returns the summary with ``rc1``, ``rc2``, the epoch the SIGTERM was
    sent at (None if the run ended first) and ``stop``."""
    model_dir.mkdir(parents=True, exist_ok=True)
    log = model_dir / "soak_train.log"
    args = [*common_args(model_dir, train_n), *overrides]
    print(f"soak: phase 1 - preset run, SIGTERM at epoch {sigterm_epoch}",
          file=sys.stderr, flush=True)
    sent = None
    t0 = time.monotonic()
    with open(log, "w") as fh, launched(device, args, fh) as proc:
        while proc.poll() is None:
            ep = epochs_done(model_dir)
            if ep >= sigterm_epoch:
                print(f"soak: epoch {ep} reached - SIGTERM to {proc.pid}",
                      file=sys.stderr, flush=True)
                proc.send_signal(signal.SIGTERM)
                sent = ep
                break
            time.sleep(poll)
        stop_s, resume_s = limits(time.monotonic() - t0,
                                  epochs_done(model_dir),
                                  total_epochs(model_dir))
        rc1 = waited(proc, stop_s)
    print(f"soak: phase 1 exited rc={rc1} (graceful stop: 0)\n"
          f"{tail(log, 4)}", file=sys.stderr, flush=True)
    stop = stop_point(log.read_text())

    print("soak: phase 2 - resume to completion", file=sys.stderr,
          flush=True)
    with open(log, "a") as fh, launched(
            device, [*args, "resume=True", "exp_id=1"], fh) as proc:
        rc2 = waited(proc, resume_s)
    print(f"soak: phase 2 exited rc={rc2}\n{tail(log, 6)}", file=sys.stderr,
          flush=True)
    return {**summarize(model_dir, log), "rc1": rc1, "rc2": rc2,
            "sigterm_at_epoch": sent, "stop": stop}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("model_dir", nargs="?",
                    default=str(Path(tempfile.gettempdir())
                                / "soak_model_dir"))
    ap.add_argument("train_n", nargs="?", type=int, default=1000)
    ap.add_argument("sigterm_epoch", nargs="?", type=int, default=40)
    ap.add_argument("--poll", type=float, default=20.0,
                    help="seconds between polls of the run's records")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the preset's device")
    args = ap.parse_args(argv)
    summary = drill(Path(args.model_dir), args.train_n, args.sigterm_epoch,
                    args.poll, args.device)
    print("SOAK_SUMMARY " + json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
