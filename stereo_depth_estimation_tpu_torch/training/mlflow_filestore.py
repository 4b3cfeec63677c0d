"""Native MLflow FileStore writer — no mlflow package required.

Counterpart of ``stereo_depth_estimation_tpu/training/mlflow_filestore.py``
(pure Python, copied so that the port imports nothing of the JAX package);
runs land where the JAX package's land, in the same format.

It writes the on-disk layout of MLflow's FileStore backend (``mlruns/``
directories), so a stock ``mlflow ui --backend-store-uri file://...`` or
``MlflowClient`` pointed at the directory lists these runs natively, with no
mlflow package installed (when it is importable, ``training/tracking.py``
prefers it and this writer is bypassed).

Layout written (mlflow's FileStore, stable since 1.x, verified against
mlflow 3.x source ``mlflow/store/tracking/file_store.py``):

    <root>/
      <experiment_id>/
        meta.yaml            # name, artifact_location, lifecycle_stage, ...
        <run_id>/            # 32-hex run id
          meta.yaml          # run_uuid/run_id/run_name, status, times, ...
          metrics/<key>      # one line per point: "<ts_ms> <value> <step>"
          params/<key>       # single line: the value
          tags/<key>         # single line per tag (incl. mlflow.runName)
          artifacts/...      # artifact files

The JAX package's ``tests/test_tracking.py`` pins the format;
``tests/test_torch_trainer.py`` holds this copy's trees to the JAX
trainer's.
"""

from __future__ import annotations

import hashlib
import os
import re
import time
import uuid
from pathlib import Path
from typing import Any, Mapping

_INVALID_KEY_CHARS = re.compile(r"[^a-zA-Z0-9_\-. /]")


def _now_ms() -> int:
    return int(time.time() * 1000)


def _yaml_str(value: str) -> str:
    """Quote a YAML scalar the way mlflow's meta.yaml readers expect."""
    if value == "" or _INVALID_KEY_CHARS.search(value) or value != value.strip():
        return "'" + value.replace("'", "''") + "'"
    # Digit-only strings must stay strings after yaml.safe_load round-trip.
    if value.isdigit() or value in {"null", "true", "false"}:
        return "'" + value + "'"
    return value


def _write_yaml(path: Path, mapping: Mapping[str, Any]) -> None:
    lines = []
    for key in sorted(mapping):
        value = mapping[key]
        if value is None:
            rendered = "null"
        elif isinstance(value, bool):
            rendered = "true" if value else "false"
        elif isinstance(value, (int, float)):
            rendered = str(value)
        elif isinstance(value, list) and not value:
            rendered = "[]"
        else:
            rendered = _yaml_str(str(value))
        lines.append(f"{key}: {rendered}")
    path.write_text("\n".join(lines) + "\n")


def _sanitize_key(key: str) -> str:
    """Metric/param/tag keys become file names; keep mlflow's allowed set."""
    return _INVALID_KEY_CHARS.sub("_", key).strip("/") or "_"


class FileStoreRun:
    """One active run in an mlruns/ FileStore tree."""

    def __init__(self, root: Path, experiment_id: str, run_id: str) -> None:
        self.root = root
        self.experiment_id = experiment_id
        self.run_id = run_id
        self.run_dir = root / experiment_id / run_id
        self.artifacts_dir = self.run_dir / "artifacts"

    def log_param(self, key: str, value: Any) -> None:
        d = self.run_dir / "params"
        d.mkdir(parents=True, exist_ok=True)
        (d / _sanitize_key(key)).write_text(f"{value}\n")

    def log_metric(self, key: str, value: float, step: int) -> None:
        d = self.run_dir / "metrics"
        d.mkdir(parents=True, exist_ok=True)
        with (d / _sanitize_key(key)).open("a") as f:
            f.write(f"{_now_ms()} {float(value)} {int(step)}\n")

    def set_tag(self, key: str, value: Any) -> None:
        d = self.run_dir / "tags"
        d.mkdir(parents=True, exist_ok=True)
        (d / _sanitize_key(key)).write_text(f"{value}\n")

    def end(self, status: str = "FINISHED") -> None:
        meta_path = self.run_dir / "meta.yaml"
        meta = _read_yaml(meta_path)
        meta["end_time"] = _now_ms()
        meta["status"] = _RUN_STATUS[status]
        _write_yaml(meta_path, meta)


def _read_yaml(path: Path) -> dict[str, Any]:
    """Minimal flat ``key: scalar`` reader (we only read files we wrote)."""
    out: dict[str, Any] = {}
    for line in path.read_text().splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        key, _, raw = line.partition(":")
        raw = raw.strip()
        if raw.startswith("'") and raw.endswith("'"):
            value: Any = raw[1:-1].replace("''", "'")
        elif raw == "null":
            value = None
        elif raw == "[]":
            value = []
        else:
            try:
                value = int(raw)
            except ValueError:
                try:
                    value = float(raw)
                except ValueError:
                    value = raw
        out[key.strip()] = value
    return out


# mlflow.entities.RunStatus integer codes (FileStore stores the int).
_RUN_STATUS = {"RUNNING": 1, "FINISHED": 3, "FAILED": 4, "KILLED": 5}


class MlflowFileStore:
    """Experiment registry over one mlruns/ root directory."""

    def __init__(self, root: str | Path) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        (self.root / ".trash").mkdir(exist_ok=True)

    def _experiments(self) -> dict[str, str]:
        """name -> experiment_id for every live experiment in the tree."""
        found: dict[str, str] = {}
        for exp_dir in self.root.iterdir():
            meta = exp_dir / "meta.yaml"
            if not exp_dir.is_dir() or not meta.exists():
                continue
            data = _read_yaml(meta)
            if data.get("lifecycle_stage", "active") == "active":
                found[str(data.get("name"))] = str(data.get("experiment_id"))
        return found

    def get_or_create_experiment(self, name: str) -> str:
        existing = self._experiments()
        if name in existing:
            return existing[name]
        # mlflow generates random integer ids; a name digest keeps ours
        # deterministic so concurrent multihost processes agree without
        # coordination (id collisions across *different* names are 1e-18).
        exp_id = str(
            int.from_bytes(hashlib.blake2s(name.encode(), digest_size=7).digest())
        )
        exp_dir = self.root / exp_id
        exp_dir.mkdir(parents=True, exist_ok=True)
        now = _now_ms()
        _write_yaml(
            exp_dir / "meta.yaml",
            {
                "artifact_location": exp_dir.resolve().as_uri(),
                "creation_time": now,
                "experiment_id": exp_id,
                "last_update_time": now,
                "lifecycle_stage": "active",
                "name": name,
            },
        )
        return exp_id

    def start_run(self, experiment_name: str, run_name: str | None) -> FileStoreRun:
        exp_id = self.get_or_create_experiment(experiment_name)
        run_id = uuid.uuid4().hex
        run = FileStoreRun(self.root, exp_id, run_id)
        run.artifacts_dir.mkdir(parents=True, exist_ok=True)
        now = _now_ms()
        name = run_name or f"run-{run_id[:8]}"
        _write_yaml(
            run.run_dir / "meta.yaml",
            {
                "artifact_uri": run.artifacts_dir.resolve().as_uri(),
                "end_time": None,
                "entry_point_name": "",
                "experiment_id": exp_id,
                "lifecycle_stage": "active",
                "run_id": run_id,
                "run_name": name,
                "run_uuid": run_id,
                "source_name": "",
                "source_type": 4,  # mlflow SourceType.LOCAL
                "source_version": "",
                "start_time": now,
                "status": _RUN_STATUS["RUNNING"],
                "tags": [],
                "user_id": os.environ.get("USER", "unknown"),
            },
        )
        run.set_tag("mlflow.runName", name)
        return run


def filestore_root_for_uri(tracking_uri: str) -> Path | None:
    """Map a tracking URI to a FileStore root, or None if not expressible.

    ``file://<path>`` and bare paths map directly. ``sqlite:///<db>`` cannot
    be written without the mlflow package (SQLAlchemy schema), so it maps to
    an ``mlruns/`` directory next to the database file — same filesystem
    location, FileStore format — and the caller prints a notice.
    """
    if tracking_uri.startswith("file://"):
        return Path(tracking_uri[len("file://"):])
    if tracking_uri.startswith("sqlite:///"):
        db = Path(tracking_uri[len("sqlite:///"):])
        return db.parent / "mlruns"
    if "://" not in tracking_uri:
        return Path(tracking_uri)
    return None
