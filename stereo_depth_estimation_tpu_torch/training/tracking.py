"""Experiment tracking with an MLflow-format backbone.

Counterpart of ``stereo_depth_estimation_tpu/training/tracking.py`` (pure
Python, copied so that the port imports nothing of the JAX package).

The reference treats MLflow as its observability backbone (train.py:580-681:
params, step metrics every 10 batches, epoch metrics, artifacts, tags). This
module keeps that exact logging surface behind one small API with three
backends, chosen in order:

1. **mlflow package** — used whenever importable (it is a default
   dependency in pyproject.toml, like the reference's); supports every URI
   mlflow does, including the reference-default ``sqlite:///``.
2. **native FileStore writer** (``mlflow_filestore.py``) — when the package
   is absent, runs are written in MLflow's FileStore ``mlruns/`` on-disk
   format, which a stock ``mlflow ui`` reads directly. ``sqlite:///`` URIs
   land in an ``mlruns/`` directory next to the database path (the
   SQLAlchemy schema needs the package).
3. **JSONL fallback** — explicit ``jsonl://<dir>`` URIs, or URIs neither
   backend can express (e.g. ``http://`` without the package).
"""

from __future__ import annotations

import json
import shutil
import time
import uuid
from pathlib import Path
from typing import Any, Mapping

from .mlflow_filestore import MlflowFileStore, filestore_root_for_uri

try:  # pragma: no cover - exercised only where mlflow is installed
    import mlflow as _mlflow
except ImportError:
    _mlflow = None


class TrackingRun:
    """One active run. All methods mirror the mlflow calls the reference makes."""

    def __init__(
        self,
        tracking_uri: str,
        experiment: str,
        run_name: str | None,
        *,
        force_local: bool = False,
    ) -> None:
        self._backend = "jsonl"
        self.run_id: str
        filestore_root = (
            None if tracking_uri.startswith("jsonl://")
            else filestore_root_for_uri(tracking_uri)
        )
        if _mlflow is not None and not force_local and not tracking_uri.startswith("jsonl://"):
            self._backend = "mlflow"
            _mlflow.set_tracking_uri(tracking_uri)
            _mlflow.set_experiment(experiment)
            self._active = _mlflow.start_run(run_name=run_name)
            self.run_id = self._active.info.run_id
        elif filestore_root is not None and not force_local:
            self._backend = "filestore"
            if tracking_uri.startswith("sqlite:///"):
                print(
                    f"[tracking] mlflow package not installed; writing "
                    f"MLflow FileStore format to {filestore_root} instead of "
                    f"the sqlite store {tracking_uri}"
                )
            self._store = MlflowFileStore(filestore_root)
            self._run = self._store.start_run(experiment, run_name)
            self.run_id = self._run.run_id
        else:
            self.run_id = uuid.uuid4().hex
            base = tracking_uri
            for prefix in ("sqlite:///", "file://", "jsonl://"):
                if base.startswith(prefix):
                    base = base[len(prefix):]
            root = Path(base).parent if base.endswith(".db") else Path(base)
            self._dir = root / "tracking" / experiment / self.run_id
            self._dir.mkdir(parents=True, exist_ok=True)
            self._metrics_file = (self._dir / "metrics.jsonl").open("a")
            (self._dir / "run.json").write_text(
                json.dumps(
                    {"run_name": run_name, "experiment": experiment,
                     "started_at_unix": time.time()},
                    indent=2,
                )
            )
            self._params: dict[str, Any] = {}
            self._tags: dict[str, Any] = {}

    # --- mlflow-parity surface -------------------------------------------
    def log_params(self, params: Mapping[str, Any]) -> None:
        if self._backend == "mlflow":
            _mlflow.log_params(dict(params))
        elif self._backend == "filestore":
            for key, value in params.items():
                self._run.log_param(key, value)
        else:
            self._params.update(params)
            (self._dir / "params.json").write_text(
                json.dumps(self._params, indent=2, default=str)
            )

    def log_metrics(self, metrics: Mapping[str, float], step: int) -> None:
        if self._backend == "mlflow":
            _mlflow.log_metrics(dict(metrics), step=step)
        elif self._backend == "filestore":
            for key, value in metrics.items():
                self._run.log_metric(key, float(value), step)
        else:
            self._metrics_file.write(
                json.dumps(
                    {"step": step, "time": time.time(),
                     **{k: float(v) for k, v in metrics.items()}}
                )
                + "\n"
            )
            self._metrics_file.flush()

    def log_artifact(self, path: str | Path, artifact_path: str | None = None) -> None:
        if self._backend == "mlflow":
            _mlflow.log_artifact(str(path), artifact_path=artifact_path)
            return
        if self._backend == "filestore":
            dest = self._run.artifacts_dir / (artifact_path or "")
        else:
            dest = self._dir / "artifacts" / (artifact_path or "")
        dest.mkdir(parents=True, exist_ok=True)
        shutil.copy2(path, dest / Path(path).name)

    def log_artifacts(self, directory: str | Path, artifact_path: str | None = None) -> None:
        if self._backend == "mlflow":
            _mlflow.log_artifacts(str(directory), artifact_path=artifact_path)
            return
        if self._backend == "filestore":
            dest = self._run.artifacts_dir / (artifact_path or "")
        else:
            dest = self._dir / "artifacts" / (artifact_path or "")
        shutil.copytree(directory, dest, dirs_exist_ok=True)

    def set_tag(self, key: str, value: Any) -> None:
        if self._backend == "mlflow":
            _mlflow.set_tag(key, value)
        elif self._backend == "filestore":
            self._run.set_tag(key, value)
        else:
            self._tags[key] = value
            (self._dir / "tags.json").write_text(
                json.dumps(self._tags, indent=2, default=str)
            )

    def end(self) -> None:
        if self._backend == "mlflow":
            _mlflow.end_run()
        elif self._backend == "filestore":
            self._run.end()
        else:
            self._metrics_file.close()

    def __enter__(self) -> "TrackingRun":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.end()

    @property
    def backend(self) -> str:
        return self._backend
