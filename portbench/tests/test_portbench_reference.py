"""The plain references against hand-computed cases."""
import numpy as np
import pytest
import torch

from portbench.tests.helpers import ROOT  # noqa: F401
from portbench import common

KEYED = common.load_module(common.HERE / "reference" / "keyed_tenants.py", "portbench_reference_keyed_tenants")


def test_argmax_takes_the_first_largest():
    scores = torch.tensor([[0.4, 0.4, 0.2], [0.1, 0.2, 0.7]])
    assert KEYED.predicted(torch, scores, torch.float64).tolist() == [0, 2]


def test_keyed_counts_by_hand_with_padding():
    ids = np.array([0, 0, 1, -1, 1])
    pred = np.array([1, 1, 0, 1, 1])
    target = np.array([1, 0, 0, 1, 0])
    cnt = KEYED.counts(ids, pred, target, 2, 2)
    assert cnt["n"].tolist() == [2, 2]
    assert cnt["tp"].tolist() == [[0, 1], [1, 0]]
    assert cnt["fp"].tolist() == [[0, 1], [0, 1]]
    assert cnt["fn"].tolist() == [[1, 0], [1, 0]]
    assert cnt["tn"].tolist() == [[1, 0], [0, 1]]
    values = KEYED.values(torch, cnt, torch.float64)
    assert values["Accuracy"].tolist() == pytest.approx([0.5, 0.5])
    # tenant 0: precision (0, 1/2), recall (0, 1): F1 (0, 2/3)
    assert values["F1"][0].item() == pytest.approx((0 + 2 / 3) / 2)
    micro, macro = KEYED.state(cnt, 2, times=3)
    assert micro["tp"].tolist() == [3, 3] and micro["fp"].tolist() == [3, 3]
    assert micro["tn"].tolist() == [(2 - 1) * 2 * 3 - 3] * 2
    assert (macro["tp"] == 3 * cnt["tp"]).all()


def test_keyed_state_off_counts_missing_bundles_whole():
    cnt = KEYED.counts(np.array([0]), np.array([0]), np.array([0]), 1, 2)
    micro, macro = KEYED.state(cnt, 2)
    got = {"a": {k: torch.from_numpy(v) for k, v in micro.items()}}
    assert KEYED.state_off(got, micro, macro) == sum(v.size for v in macro.values())
