"""Fixtures that the port's CPU tests share.

A test module takes a fixture by importing it by name:

    from repro_torch.testing import one_torch_thread  # noqa: F401

``sync_budget_guard`` (autouse, per test) enforces
``@pytest.mark.sync_budget(n)``: the marked test body may make at most
``n`` host syncs (``repro_torch.analysis.sync_guard``); unmarked tests are
unaffected.

The port's CPU paths run many small eager ops. The suite runs several
pytest workers on one machine's cores, and torch's intra-op thread pool in
each worker then only contends for them: beside five other workers a
module ran 5-200x slower on torch's default threads than on one.
"""
import pytest
import torch

from repro_torch.analysis.sync_guard import make_autouse_fixture


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the importing test module on one torch thread, and restore the
    thread count after its last test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


sync_budget_guard = make_autouse_fixture(pytest)
