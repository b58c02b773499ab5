"""A run with the timed path broken underneath comes out not correct, once
for each fault the cell can have; a sound run comes out correct."""

import pytest

from portbench.drivers import exact_ksd, sampled_ksd
from portbench.faults import planted
from portbench.tests import tiny

CASES = [("tiny_exact", f) for f in exact_ksd.FAULTS] + [
    ("tiny_sampled", f) for f in sampled_ksd.FAULTS]


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("pb"))


@pytest.mark.parametrize("cell", ["tiny_exact", "tiny_sampled"])
def test_a_sound_run_is_correct(copy, cell):
    res = tiny.run(copy, cell)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(copy, cell, fault):
    with planted(fault):
        res = tiny.run(copy, cell)
    assert not res["correct"], res["checks"]
