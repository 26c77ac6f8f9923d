"""The comparison catches the control and every fault the cells can
have: a whole run on the CPU, the program (or the reference in its place)
broken underneath, comes out not correct."""
import pytest

from portbench import control, harness
from portbench.catalog import cell_of

ONE = "portbench/configs/lubm100.json"
SHARD4 = "portbench/configs/lubm100_shard4.json"


def test_the_control_is_not_correct():
    # packed 16-bit keys collide once ids pass 2^16: LUBM(10) has 330k terms
    res = harness.run(cell_of(ONE, "analytic"), 31, 0.3, trace=False,
                      device="cpu", scale=10,
                      stand_in=control.packed16_stand_in)
    assert res["correct"] is False
    assert res["checks"]["wrong_requests"]["value"] > 0
    assert res["checks"]["wrong_rows"]["value"] > 0


@pytest.mark.parametrize("config, fault", [
    (SHARD4, "altered_answer"), (SHARD4, "half_batch_dropped"),
    (SHARD4, "stale_answer"), (SHARD4, "exchange_left_out"),
    (ONE, "altered_answer"), (ONE, "half_batch_dropped"),
    (ONE, "stale_answer"),
])
def test_a_broken_program_is_not_correct(config, fault):
    res = harness.run(cell_of(config, "analytic"), 32, 1.0, trace=False,
                      device="cpu", scale=2, fault=control.FAULTS[fault])
    assert res["correct"] is False, res["checks"]
    assert res["attempted"] > 0


@pytest.mark.parametrize("config", [ONE, SHARD4])
def test_a_sound_run_is_correct(config):
    res = harness.run(cell_of(config, "analytic"), 33, 1.0, trace=False,
                      device="cpu", scale=2)
    assert res["correct"] is True, res["checks"]
