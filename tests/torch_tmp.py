"""Cleanup of what the port's tests write under pytest's temporary
directory: engine run directories with their checkpoints, the ranks' saved
states, frame trees. pytest keeps the base directories of the last three
sessions, so without this a few tier-1 runs on one machine hold tens of GB
(one run wrote 9 GB). A test module imports :func:`drop_tmp_path` (autouse:
each test's ``tmp_path`` is removed when the test is done with it, after
its checks) and removes its module fixtures' directories with
:func:`module_tmp` at module teardown. What the tests check is unchanged."""

from __future__ import annotations

import contextlib
import shutil

import pytest


@pytest.fixture(autouse=True)
def drop_tmp_path(request):
    path = request.getfixturevalue("tmp_path") if "tmp_path" in request.fixturenames else None
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


@contextlib.contextmanager
def module_tmp(tmp_path_factory, name: str):
    """A fresh directory under pytest's base temporary directory, removed
    when the block ends (a module fixture yields inside it)."""
    path = tmp_path_factory.mktemp(name)
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)
