"""The training scripts' console entry points: ``pyproject.toml`` names
``speechflow-torch-train``, ``-train-vocoder``, ``-train-aligner`` and
``-train-g2p`` beside the JAX package's, and each ``cli`` parses ``--help``
(exit code 0, its usage printed) on the CPU."""

import importlib
import sys
import tomllib
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
SCRIPTS = {"speechflow-torch-train": "train_tts", "speechflow-torch-train-vocoder": "train_vocoder",
           "speechflow-torch-train-aligner": "train_aligner",
           "speechflow-torch-train-g2p": "train_g2p"}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_console_script_parses_help(name, monkeypatch, capsys):
    with open(REPO / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts[name] == f"speechflow_torch.scripts.{SCRIPTS[name]}:cli"
    assert scripts[name.replace("torch", "tpu")] == \
        f"speechflow_tpu.scripts.{SCRIPTS[name]}:cli"
    module = importlib.import_module(f"speechflow_torch.scripts.{SCRIPTS[name]}")
    monkeypatch.setattr(sys, "argv", [name, "--help"])
    with pytest.raises(SystemExit) as exit_:
        module.cli()
    assert exit_.value.code == 0 and "usage" in capsys.readouterr().out
