"""Training observability: metric tracking, timers, run-dir management
(counterpart of ``ezaudio_tpu/training/tracker.py``).

Equivalents of the reference's audiotools observability stack:
  * ``Tracker`` (audiotools/ml/decorators.py:118-440): scoped metric
    history with running means, ``is_best``, ``state_dict``; one process
    trains on one card, so there is no cross-rank reduction (the
    reference's ``@track`` all_reduce, decorators.py:322-327);
  * ``timer`` (decorators.py:91-116): a context-manager phase timer;
  * ``Experiment`` (audiotools/ml/experiment.py:16-110): run-dir manager
    with random names + git snapshot;
  * JSONL metric log (the reference writes log.txt / TensorBoard).

Plus ``profile_trace``: ``torch.profiler`` over a block (host and CUDA
activity), its trace written to the directory as a Chrome trace JSON that
Perfetto and TensorBoard read.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time
from collections import defaultdict, deque
from typing import Dict, Optional


class Tracker:
    def __init__(self, log_file: Optional[str] = None, history: int = 100):
        self.log_file = log_file
        self.history = history
        self.metrics: Dict[str, deque] = defaultdict(lambda: deque(maxlen=history))
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.best: Dict[str, float] = {}
        self.step = 0

    def update(self, scope: str, metrics: Dict[str, float]):
        for k, v in metrics.items():
            key = f"{scope}/{k}"
            v = float(v)
            self.metrics[key].append(v)
            self.totals[key] += v
            self.counts[key] += 1

    def mean(self, key: str) -> float:
        q = self.metrics[key]
        return sum(q) / max(len(q), 1)

    def is_best(self, key: str, minimize: bool = True) -> bool:
        if not self.metrics[key]:
            # no data recorded for this key (e.g. right after resume —
            # state_dict doesn't serialize the rolling windows): never
            # declare a best from the empty-mean 0.0
            return False
        cur = self.mean(key)
        prev = self.best.get(key)
        better = prev is None or (cur < prev if minimize else cur > prev)
        if better:
            self.best[key] = cur
        return better

    def log(self, step: Optional[int] = None, **extra):
        self.step = step if step is not None else self.step + 1
        record = {"step": self.step, **{k: self.mean(k) for k in self.metrics},
                  **extra}
        if self.log_file:
            with open(self.log_file, "a") as f:
                f.write(json.dumps(record) + "\n")
        return record

    def state_dict(self) -> dict:
        return {"best": dict(self.best), "step": self.step,
                "totals": dict(self.totals), "counts": dict(self.counts)}

    def load_state_dict(self, state: dict):
        self.best = dict(state["best"])
        self.step = state["step"]
        self.totals = defaultdict(float, state["totals"])
        self.counts = defaultdict(int, state["counts"])


@contextlib.contextmanager
def timer(tracker: Optional[Tracker] = None, name: str = "block"):
    t0 = time.perf_counter()
    try:
        yield
    finally:  # record even when the timed block raises
        dt = time.perf_counter() - t0
        if tracker is not None:
            tracker.update("time", {name: dt})


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block into
    ``<log_dir>/trace.json``; yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Experiment:
    """Run-directory manager (audiotools/ml/experiment.py parity): creates
    ``{parent}/{name}``, snapshots the git commit, and chdirs within a
    context."""

    ADJECTIVES = ["swift", "quiet", "amber", "bold", "misty", "solar"]
    NOUNS = ["falcon", "river", "ember", "drift", "aurora", "echo"]

    def __init__(self, exp_directory: str = "runs", exp_name: Optional[str] = None,
                 seed: Optional[int] = None):
        import random as _random

        rnd = _random.Random(seed)
        if exp_name is None:
            exp_name = (f"{rnd.choice(self.ADJECTIVES)}-{rnd.choice(self.NOUNS)}-"
                        f"{int(time.time()) % 100000}")
        self.exp_dir = os.path.join(exp_directory, exp_name)
        os.makedirs(self.exp_dir, exist_ok=True)
        self._snapshot_git()

    def _snapshot_git(self):
        try:
            commit = subprocess.run(
                ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                timeout=10).stdout.strip()
            diff = subprocess.run(
                ["git", "diff"], capture_output=True, text=True,
                timeout=10).stdout
            with open(os.path.join(self.exp_dir, "git.json"), "w") as f:
                json.dump({"commit": commit}, f)
            if diff:
                with open(os.path.join(self.exp_dir, "git.diff"), "w") as f:
                    f.write(diff)
        except Exception:
            pass  # not a git checkout

    @contextlib.contextmanager
    def __call__(self):
        old = os.getcwd()
        os.chdir(self.exp_dir)
        try:
            yield self.exp_dir
        finally:
            os.chdir(old)
