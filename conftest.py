"""Repo-level pytest wiring.

* Puts ``src/`` (the ``repro`` package) and ``tests/`` (shared helpers like
  ``_hypothesis_compat``) on ``sys.path`` so ``python -m pytest`` works with
  no PYTHONPATH ceremony.
* Registers the ``slow`` marker and deselects slow tests by default — the
  default tier stays under ~2 minutes.  Run everything with ``--runslow``
  (or select explicitly via ``-m slow``).
"""
from __future__ import annotations

import os
import sys

import pytest

_ROOT = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.join(_ROOT, "src"), os.path.join(_ROOT, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="also run tests marked @pytest.mark.slow")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long model-smoke / system tests excluded from the default "
        "fast tier (enable with --runslow or -m slow)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the PyTorch port's hand-written kernels); "
        "skips with a reason where there is none")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or config.getoption("-m"):
        return
    skip_slow = pytest.mark.skip(
        reason="slow tier: pass --runslow (or -m slow) to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)
