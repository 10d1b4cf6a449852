"""Fixtures of the benchmark's CPU tests (see tiny.py)."""

import pytest

import tiny  # noqa: F401  (puts the repository's root on sys.path)


@pytest.fixture
def program():
    from gpubench.harness import cells

    return cells.Program("cpu", {"quality": "balanced"})
