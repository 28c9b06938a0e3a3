"""Shared fixtures of the benchmark's tests: the harness's own modules on
the path, the tiny configuration and traffic files, and the skip of the
tests that need a CUDA card."""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def data(name: str) -> dict:
    with open(os.path.join(HERE, "data", name + ".json")) as f:
        return json.load(f)


@pytest.fixture
def tiny():
    return data("tiny")


@pytest.fixture
def cuda_card():
    """Skips the test where no CUDA card is present (decided here, at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def tmpdir_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return tmp_path
