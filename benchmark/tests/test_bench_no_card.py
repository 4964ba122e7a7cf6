"""The measurement path needs a card: without one the command exits with
code 2 and prints no result, and the harness raises for a cuda device
instead of falling back to the CPU."""

import pytest
import torch

from benchmark import harness, run


def test_command_refuses_without_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "impurity_nb13.gs", "--seed", "7",
                   "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc == 2 and out == "" and "card" in err


def test_harness_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CPU fallback"):
        harness.run_cell(harness.load_spec(), "impurity_nb13.gs", 7, 1.0,
                         False, "cuda")


def test_forbidden_modules_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "dmft_ed_tpu_torch_x",
                        types.ModuleType("dmft_ed_tpu_torch_x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert harness.forbidden_modules() == ["jaxlib"]
