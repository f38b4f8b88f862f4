"""The control: the reference put in the program's place one precision
step below the served bfloat16 (float8 matrix products) has to fail each
cell's limit, while the program passes it.  On the card at each cell's
own size and load (three seeds, a short window); on the CPU at the tiny
size, where the float32 program reads no gap and the control a clear
one."""
import time

import pytest

import run as R
from bench import spec
from conftest import tiny_cell, with_held

CELLS = ("starcoder2-3b.code-completion", "minicpm-2b.chat-heavy-closed")


@pytest.mark.parametrize("name", CELLS)
def test_the_control_strays_where_the_program_does_not(name):
    out = R.run(tiny_cell(name), 2**31 + 7, 2.5, False, "cpu",
                time.perf_counter(), control=True)
    gap = out["check"]["widest_gap"]["value"]
    assert out["correct"] and gap <= 1e-3
    assert out["info"]["control_gap"] > 10 * max(gap, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_cells_limit_on_the_card(name, cuda):
    cell = spec.load(name, benchmark=with_held())
    limit = cell.check["gap_limit"]
    for seed in (5100000001, 5100000002, 5100000003):
        out = R.run(cell, seed, 20.0, False, "cuda", time.perf_counter(),
                    control=True)
        assert out["correct"], out["check"]
        assert out["check"]["widest_gap"]["value"] <= limit
        assert out["info"]["control_gap"] > limit
