"""Step-scoped ``torch.profiler`` capture for the trainer.

Counterpart of ``stereo_depth_estimation_tpu/training/profiling.py`` with
``torch.profiler`` in place of ``jax.profiler``: ``--profile-dir`` arms a
capture of ``--profile-steps`` training batches after the first (which
builds the kernels and picks cuDNN algorithms), written as a Chrome trace
(``trace.json``, readable by Perfetto or chrome://tracing). The trace
carries the train step's ``train.*`` spans (``spans.py``) as rows on the
clock of its device rows.
"""

from __future__ import annotations

from pathlib import Path

import torch


class StepProfiler:
    """Trace training batches [skip_steps, skip_steps + num_steps).

    ``step()`` is called once per training batch, before the batch runs."""

    def __init__(
        self, logdir: str | Path | None, num_steps: int = 10, skip_steps: int = 1
    ) -> None:
        self.logdir = Path(logdir) if logdir else None
        self.num_steps = num_steps
        self.skip_steps = skip_steps
        self._seen = 0
        self._started_at = 0
        self._profile: torch.profiler.profile | None = None
        self._done = self.logdir is None

    def step(self) -> None:
        if self._done:
            return
        if self._profile is None:
            if self._seen >= self.skip_steps:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                self._profile = torch.profiler.profile(activities=activities)
                self._profile.start()
                self._started_at = self._seen
        elif self._seen - self._started_at >= self.num_steps:
            self.stop()
        self._seen += 1

    def stop(self) -> None:
        if self._profile is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._profile.stop()
            self.logdir.mkdir(parents=True, exist_ok=True)
            self._profile.export_chrome_trace(str(self.logdir / "trace.json"))
            self._profile = None
            print(f"Profiler trace written to {self.logdir}")
        self._done = True
