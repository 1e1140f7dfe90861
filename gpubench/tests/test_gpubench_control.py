"""The control (the reference one precision below the configuration's, in
the program's place) comes out not correct under the cell's limits, and
the program correct; on the CPU at a cut size, and on the card."""
import pytest
import torch

from gpubench import control, harness
from gpubench.tests import tiny


def test_float8_sample_loop_fails_on_the_cpu():
    harness.configure_torch()
    row = control.serving(tiny.spec("tts_batch.lj_mol"), 5, 0.5,
                          torch.device("cpu"))
    lim = tiny.TINY_LIMITS["sample_gap"]
    assert row["program"]["sample_gap"] <= lim < row["control"]["sample_gap"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's readings are the "
                    "card's kernels against its plain reference")
    harness.cache_env(harness.ROOT)
    harness.configure_torch()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tts_batch.lj_mol", "tts_single.lj_mol"])
def test_serving_control_fails_on_the_card(card, cell):
    spec = harness.cell_spec(harness.load_manifest(harness.ROOT), cell)
    spec["mix"]["lengths"] = [40, 60] if spec["mix"]["batch"] > 1 else [60]
    row = control.serving(spec, 3, 1.0, card)
    lim = spec["limits"]
    assert all(row["program"][k] <= v for k, v in lim.items()), row
    assert any(row["control"][k] > v for k, v in lim.items()), row


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["train_af.lj_af_offline",
                                  "train_voc.lj_mol"])
def test_training_control_and_faults_fail_on_the_card(card, cell):
    spec = harness.cell_spec(harness.load_manifest(harness.ROOT), cell)
    row = control.training(spec, 3, card)
    lim = spec["limits"]
    assert all(row["program"][k] <= v for k, v in lim.items()), row
    for kind in ("control", "half_batch", "frozen"):
        assert any(row[kind][k] > v for k, v in lim.items()), (kind, row)
