"""Single-module checkpoints (counterpart of ``speechflow_tpu/utils/state_io.py``).

``save_module`` of the JAX package writes one pickle of
``{"params": <params dict>, "state": <nnx pure dict of numpy arrays>}``: the
one JAX checkpoint format the port reads with nothing but pickle and numpy.
``load_module`` rebuilds the port's counterpart through
``speechflow_torch.convert``; ``save_module`` writes the same pickle from a
port module (``convert.nnx_from_module``), so either package loads it.
"""

from __future__ import annotations

import dataclasses
import pickle
import typing as tp
from pathlib import Path

import torch

from speechflow_torch.convert import load_nnx_state, nnx_from_module
from speechflow_torch.utils.device import resolve_device

__all__ = ["save_module", "load_module"]


def save_module(model: torch.nn.Module, params, path: tp.Union[str, Path]) -> Path:
    """Persist a port module and its params as the JAX ``save_module`` does: one
    pickle of ``{"params": params as a dict, "state": the JAX pure-dict layout}``
    (float32 numpy leaves, list indices as ints)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"params": dataclasses.asdict(params), "state": nnx_from_module(model)}, f)
    return path


def load_module(model_cls, params_cls, path: tp.Union[str, Path],
                device: tp.Union[str, torch.device, None] = None,
                dtype: torch.dtype = torch.float32):
    """Rebuild a module saved by the JAX ``save_module`` (a pickle this project
    wrote: unpickling runs code). Returns ``(model, params)``, the model in
    eval mode on ``device`` (the GPU unless ``device="cpu"``) in ``dtype``."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        tree = pickle.load(f)
    params = params_cls.create(tree["params"])
    model = load_nnx_state(model_cls(params), tree["state"])
    return model.to(dev, dtype).eval(), params
