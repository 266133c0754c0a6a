"""Card tests: the control, the program in the precision below the
configuration's (the e4m3 paths of each cell's ``check.control``), must
come out not correct at each cell's own size; the seeded weights must draw
alike in place and fresh on the card. Run on a machine with an H100:

    python -m pytest serve_bench/tests/test_card.py -m cuda
"""

import pytest
import torch

import serve_bench.run as R
from serve_bench import weights as W
from serve_bench.model import ModelShape
from serve_bench.registry import Registry

CELLS = ("mistral7b.chat", "mistral-small-24b.chat",
         "mistral7b.longctx_decode")


@pytest.fixture(scope="module")
def reg():
    return Registry(R.ROOT, R.BENCH_DIR)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 202, 2**31 + 303])
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, reg, cell, seed):
    out = R.run_cell(reg, cell, seed, 10.0, False,
                     overrides=reg.cell(cell)["check"]["control"])
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
def test_weights_drawn_in_place_equal_fresh_on_the_card(card, reg):
    m = ModelShape.from_config(reg.config("mistral-7b-v0.3"))
    params = W.fill_params(m, 2**31 + 5, card)
    for i in (0, m.layers - 1):
        fresh = W.layer(m, 2**31 + 5, i, card)
        for name in W.LAYER_MATS:
            assert torch.equal(params[name][i], fresh[name])
