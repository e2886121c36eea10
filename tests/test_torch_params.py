"""The params base against the JAX package's: every recipe's model section
under ``default`` and ``debug`` through both packages' ``Params.create``
(equal field names, values and Python types, as pydantic's validation gives
them on the JAX side), the ``deprecated_fields`` migration,
``init_from_parent_params`` and ``BaseModel``'s ``n_parameters`` and
``params_dict``. Exact equality throughout."""

import dataclasses
import typing as tp
from pathlib import Path

import numpy as np
import pytest
import torch

from speechflow_torch.io.config import Config
from speechflow_torch.training import base_model as TB

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent

# recipe file -> the params class its model section builds, by module path
RECIPES = {
    "aligner_model.yml": ("models.aligner.model", "GlowTTSParams"),
    "prosody_model.yml": ("models.prosody.model", "ProsodyParams"),
    "tts_forward.yml": ("models.tts.model", "ParallelTTSParams"),
    "tts_model.yml": ("models.tts.model", "ParallelTTSParams"),
    "vocoder_bigvgan.yml": ("models.vocoder.model", "VocosParams"),
    "vocoder_mel_dac.yml": ("models.vocoder.model", "VocosParams"),
    "vocoder_model.yml": ("models.vocoder.model", "VocosParams"),
    "vocoder_nsf.yml": ("models.vocoder.model", "VocosParams"),
    "vocoder_styletts2_e2e.yml": ("models.vocoder.model", "VocosParams"),
    "vocoder_styletts2_e2e_ft.yml": ("models.vocoder.model", "VocosParams"),
    "xtts_model.yml": ("models.tts.xtts", "XTTSParams"),
}


def _classes(module: str, name: str):
    import importlib

    return (getattr(importlib.import_module(f"speechflow_torch.{module}"), name),
            getattr(importlib.import_module(f"speechflow_tpu.{module}"), name))


def _typed(v: tp.Any) -> tp.Any:
    """A value with its Python types spelled out, for exact comparison."""
    if isinstance(v, dict):
        return ("dict", {k: _typed(x) for k, x in v.items()})
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, [_typed(x) for x in v])
    if dataclasses.is_dataclass(v):
        return _typed(dataclasses.asdict(v))
    if hasattr(v, "model_dump"):
        return _typed(v.model_dump())
    return (type(v).__name__, v)


def test_every_model_config_is_a_recipe():
    with_model = sorted(p.name for p in (REPO / "configs").glob("*.yml")
                        if "model" in Config.create_from_file(p))
    assert with_model == sorted(RECIPES)


@pytest.mark.parametrize("select", ["default", "debug"])
@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_recipe_params_match_jax(recipe, select):
    ours_cls, theirs_cls = _classes(*RECIPES[recipe])
    section = Config.create_from_file(REPO / "configs" / recipe, value_select=[select])["model"]
    ours = ours_cls.create(section.to_dict())
    theirs = theirs_cls.create(section.to_dict())
    assert [f.name for f in dataclasses.fields(ours)] == list(type(theirs).model_fields)
    mine, ref = ours.to_dict(), theirs.to_dict()
    for name in ref:
        assert _typed(mine[name]) == _typed(ref[name]), name
    assert ours.fields_set == theirs.model_fields_set


@dataclasses.dataclass
class _Renamed(TB.BaseModelParams):
    width: int = 8
    depth: int = 2
    rate: float = 0.5
    rates: tp.Tuple[int, ...] = (2, 2)

    @classmethod
    def deprecated_fields(cls):
        return {"dim": "width", "old_flag": ""}


def _jax_renamed():
    from speechflow_tpu.training.base_model import BaseModelParams

    class JRenamed(BaseModelParams):
        width: int = 8
        depth: int = 2
        rate: float = 0.5
        rates: tp.Tuple[int, ...] = (2, 2)

        @classmethod
        def deprecated_fields(cls):
            return {"dim": "width", "old_flag": ""}

    return JRenamed


@pytest.mark.parametrize("cfg", [
    {"dim": 16, "old_flag": True},
    {"dim": 16, "width": 32},
    {"rate": 1, "rates": [4, 8], "depth": 3.0},
    {"dim": 4, "unknown": 1},
])
def test_deprecated_fields_migrate_as_jax(cfg):
    ours, theirs = _Renamed.create(dict(cfg)), _jax_renamed().create(dict(cfg))
    assert _typed(ours.to_dict()) == _typed(theirs.to_dict())
    assert ours.fields_set == theirs.model_fields_set


@pytest.mark.parametrize("only_missing", [True, False])
def test_init_from_parent_params_as_jax(only_missing):
    from speechflow_torch.models.vocoder.model import VocosParams
    from speechflow_tpu.models.vocoder.model import VocosParams as JVocosParams

    parent_cfg = {"dim": 96, "n_layers": 3, "n_mels": 80, "sample_rate": 22050}
    child_cfg = {"dim": 64, "hop_length": 128}
    ours = VocosParams.create(child_cfg).init_from_parent_params(
        VocosParams.create(parent_cfg), only_missing=only_missing)
    theirs = JVocosParams.create(child_cfg).init_from_parent_params(
        JVocosParams.create(parent_cfg), only_missing=only_missing)
    assert _typed(ours.to_dict()) == _typed(theirs.to_dict())
    assert ours.dim == (64 if only_missing else 96) and ours.n_mels == 80


def test_base_model_counts_parameters():
    from speechflow_torch.models.vocoder.model import VocosParams

    class Tiny(TB.BaseModel):
        def __init__(self, params):
            super().__init__(params)
            self.lin = torch.nn.Linear(3, 5)
            self.register_buffer("stat", torch.zeros(7))

    m = Tiny(VocosParams.create({"dim": 16}))
    assert m.n_parameters == 3 * 5 + 5
    assert m.params_dict["dim"] == 16 and np.isscalar(m.params_dict["n_layers"])

    from flax import nnx

    from speechflow_tpu.models.vocoder.model import VocosParams as JVocosParams
    from speechflow_tpu.training.base_model import BaseModel as JBaseModel

    class JTiny(JBaseModel):
        def __init__(self, params):
            super().__init__(params)
            self.lin = nnx.Linear(3, 5, rngs=nnx.Rngs(0))

    ref = JTiny(JVocosParams.create({"dim": 16}))
    assert ref.n_parameters == m.n_parameters
    assert _typed(ref.params_dict) == _typed(m.params_dict)
