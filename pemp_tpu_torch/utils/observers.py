"""Omniboard/Mongo-compatible run documents.

Counterpart of ``pemp_tpu/utils/observers.py`` (reference
utils/misc.py:34-45, config.py:17-19: ``g.mongodb``, ``g.mongo_port``,
the database named after the experiment). The documents follow Sacred's
MongoObserver schema: ``runs`` (``_id``, experiment, command, host,
start time, config, status, result, heartbeat, ``info.metrics`` links)
and ``metrics`` (name, run id, steps, values, timestamps), which is what
Omniboard reads.

The port imports no ``pymongo``: it always writes the documents as
MongoDB extended JSON under ``<run_dir>/mongo/{runs,metrics}.json``, as
the JAX package does when ``pymongo`` is absent, so ``mongoimport --db
<name> --collection runs|metrics`` recreates the database. ``g.mongo_port``
is kept in the config for that import and read nowhere. The run
directory stays on either way: the checkpoints live there.
"""

from __future__ import annotations

import json
import platform
import socket
import sys
import time
from datetime import datetime, timezone
from pathlib import Path
from typing import Dict, List


def _now() -> datetime:
    return datetime.now(timezone.utc).replace(tzinfo=None)


def _ext(o):
    """MongoDB extended JSON: datetimes as ``{"$date": ISO-8601}``."""
    if isinstance(o, datetime):
        return {"$date": o.isoformat(timespec="milliseconds") + "Z"}
    if isinstance(o, dict):
        return {k: _ext(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_ext(v) for v in o]
    return o


class MongoRunObserver:
    """One run's Sacred-schema documents, written under ``run_dir/mongo``.
    The metric documents are rewritten whole (mongoimport has no
    ``$push``), so they are flushed every ``FLUSH_EVERY`` scalars or
    ``FLUSH_SECS`` seconds and at the end."""

    FLUSH_EVERY = 100
    FLUSH_SECS = 30.0

    def __init__(self, name: str, run_id: int, command: str, config: Dict,
                 run_dir: Path, tag: str = ""):
        self.doc_id = run_id    # the run dir is tag-scoped: the bare int id
        self._metrics: Dict[str, Dict] = {}
        self._pending = 0
        self._last_flush = time.monotonic()
        self._dir = Path(run_dir) / "mongo"
        self._dir.mkdir(parents=True, exist_ok=True)
        self._preload_metrics()
        self._run_doc = {
            "_id": self.doc_id,
            "pemp_tag": tag,
            "pemp_run_id": run_id,
            "format": "MongoObserver-0.7.0",
            "experiment": {"name": name, "base_dir": str(Path.cwd()),
                           "sources": [], "dependencies": [],
                           "repositories": [],
                           "mainfile": Path(sys.argv[0]).name},
            "command": command,
            "host": {"hostname": socket.gethostname(),
                     "os": [platform.system(), platform.platform()],
                     "python_version": platform.python_version(),
                     "cpu": platform.processor(), "ENV": {}},
            "meta": {"command": command,
                     "options": {"--unobserved": False}},
            "config": config,
            "start_time": _now(),
            "heartbeat": _now(),
            "status": "RUNNING",
            "resources": [], "artifacts": [], "captured_out": "",
            "info": {"metrics": [{"name": m["name"], "id": m["_id"]}
                                 for m in self._metrics.values()]},
            "result": None,
        }
        self._dump("runs.json", [self._run_doc])

    def _preload_metrics(self) -> None:
        """A resumed run reuses its directory: keep the metric history
        written before the resume."""
        path = self._dir / "metrics.json"
        if not path.exists():
            return
        for line in path.read_text().splitlines():
            if not line.strip():
                continue
            doc = json.loads(line)
            doc["timestamps"] = [
                datetime.fromisoformat(t["$date"].rstrip("Z"))
                if isinstance(t, dict) else t
                for t in doc.get("timestamps", [])]
            self._metrics[doc["name"]] = doc

    def log_scalar(self, metric: str, value: float, step: int) -> None:
        m = self._metrics.get(metric)
        if m is None:
            m = self._metrics[metric] = {
                "_id": f"{self.doc_id}.{metric}",
                "name": metric, "run_id": self.doc_id,
                "steps": [], "values": [], "timestamps": []}
            self._run_doc["info"]["metrics"].append(
                {"name": metric, "id": m["_id"]})
        now = _now()
        self._run_doc["heartbeat"] = now
        m["steps"].append(int(step))
        m["values"].append(float(value))
        m["timestamps"].append(now)
        self._pending += 1
        if (self._pending >= self.FLUSH_EVERY
                or time.monotonic() - self._last_flush > self.FLUSH_SECS):
            self._flush()

    def finish(self, status: str = "COMPLETED", result=None) -> None:
        self._run_doc["status"] = status
        self._run_doc["stop_time"] = _now()
        self._run_doc["heartbeat"] = _now()
        if result is not None:
            self._run_doc["result"] = result if isinstance(
                result, (int, float)) else str(result)
        self._flush()

    def _flush(self) -> None:
        self._pending = 0
        self._last_flush = time.monotonic()
        if self._metrics:
            self._dump("metrics.json", list(self._metrics.values()))
        self._dump("runs.json", [self._run_doc])

    def _dump(self, fname: str, docs: List[Dict]) -> None:
        """One document per line (mongoimport's default), atomically."""
        tmp = self._dir / (fname + ".tmp")
        tmp.write_text("".join(json.dumps(_ext(d)) + "\n" for d in docs))
        tmp.replace(self._dir / fname)


def maybe_attach(run, cfg, name: str, command: str) -> None:
    """Attach a ``MongoRunObserver`` to a recorded run when ``g.mongodb``
    is set (reference utils/misc.py:53 attaches one per experiment, the
    database named ``name``)."""
    if not cfg.g.mongodb or run._id is None:    # -u disables every observer
        return
    from pemp_tpu_torch.config import config_record
    run.observers.append(MongoRunObserver(
        name, run._id, command, config_record(cfg), run.run_dir,
        tag=str(cfg.tag)))
