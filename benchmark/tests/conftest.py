"""Shared by the benchmark's tests: runs on the CPU at a small size."""

from __future__ import annotations

import pytest


@pytest.fixture
def small_run(monkeypatch):
    """A run's fixed sizes cut for the CPU: a ring of 4 blocks, 2 warm-up
    blocks, the latest 2 and a sample of 3 compared."""
    from benchmark import check, harness, signal

    monkeypatch.setattr(signal, "POOL_BLOCKS", 4)
    monkeypatch.setattr(harness, "WARM_BLOCKS", 2)
    monkeypatch.setattr(check, "COMPARED_LATEST", 2)
    monkeypatch.setattr(check, "COMPARED_SAMPLED", 3)
