"""PyTorch port: the arithmetic of ``tools/step_drift.py`` (the card steps'
gradient drift table), on hand-made gradients."""

import pytest
import torch

from multi_modal_gnn_tpu_torch.tools.step_drift import drift_table, rel


def test_rel_is_the_relative_distance_and_zero_against_zero():
    b = torch.tensor([3.0, 4.0])
    assert rel(torch.tensor([3.0, 4.0]), b) == 0.0
    assert rel(torch.tensor([3.0, 9.0]), b) == pytest.approx(1.0)
    assert rel(torch.tensor([1.0, 1.0]), torch.zeros(2)) == 0.0


def test_drift_table_reads_each_run_the_spread_and_the_bf16_effect():
    cpu = {"w": torch.tensor([1.0, 0.0]), "z": torch.zeros(2)}
    card = [{"w": torch.tensor([1.0, 0.1]), "z": torch.zeros(2)},
            {"w": torch.tensor([1.0, -0.2]), "z": torch.ones(2)},
            {"w": torch.tensor([1.0, 0.0]), "z": torch.zeros(2)}]
    cpu_f32 = {"w": torch.tensor([0.5, 0.0]), "z": torch.zeros(2)}
    table = drift_table(card, cpu, cpu_f32)
    assert table["w"]["norm"] == pytest.approx(1.0)
    assert table["w"]["card_vs_cpu"] == pytest.approx([0.1, 0.2, 0.0])
    assert table["w"]["card_spread"] == pytest.approx(0.3)
    assert table["w"]["bf16_effect"] == pytest.approx(0.5)
    # a gradient of 0 on the CPU: distances are not relative to anything
    assert table["z"] == {"norm": 0.0, "card_vs_cpu": [0.0, 0.0, 0.0], "card_spread": 0.0, "bf16_effect": 0.0}
