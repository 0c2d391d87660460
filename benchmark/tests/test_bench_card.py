"""On the card: each cell at its own size, one seed, a short window: the
program passes its limits and the bfloat16 control fails one.  Run on a
machine with the card: ``python3 -m pytest benchmark/tests -m card``."""
import pytest

from benchmark import harness


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.card
@pytest.mark.parametrize("cell", ["tum_rgbd.room", "euroc_stereo.mapping"])
def test_cell_on_the_card(card, cell):
    r = harness.run_cell(cell, 7, 15.0, False, control=True)
    run = harness.LAST_RUN
    assert r["correct"], r["checked"]
    assert any(run.control[k] > v["limit"] for k, v in r["checked"].items()), run.control
    assert not run.control_correct
