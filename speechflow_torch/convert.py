"""Weights from the JAX package: an nnx pure dict onto the port's modules.

``load_nnx_state(module, pure)`` takes ``nnx.to_pure_dict(nnx.state(m))``
of a JAX model (nested dicts of numpy arrays; rng entries are ignored) and
copies it into the port's counterpart, mapping flax's layouts onto
PyTorch's:

=========================  ==========================  ===========================
flax leaf                  flax layout                 port layout
=========================  ==========================  ===========================
``Linear.kernel``          (in, out)                   ``Linear.weight`` (out, in)
``Conv.kernel``            (K, Cin/groups, Cout)       ``Conv1d.weight`` (Cout, Cin/groups, K)
``ConvTranspose.kernel``   (K, Cin, Cout)              correlation weight (Cout, Cin, K), unflipped
``MultiHeadAttention``     q/k/v kernel (in, H, dh),   ``Linear.weight`` (H·dh, in), bias (H·dh,);
                           bias (H, dh); out kernel    out weight (out, H·dh)
                           (H, dh, out)
``Embed.embedding``        (N, D)                      ``Embedding.weight`` (N, D)
``LayerNorm.scale/bias``   (D,)                        ``LayerNorm.weight/bias``
bare ``Param``             any                         same name, same shape
=========================  ==========================  ===========================

The copy is strict both ways: every parameter of the port must be filled
and every parameter of the JAX state used. This module is the only bridge
between the packages, and it takes plain arrays: it imports neither.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch
import torch.nn as nn

from speechflow_torch.models.layers import Conv1d, ConvTranspose1d, MultiHeadAttention

__all__ = ["flatten_nnx", "state_dict_from_nnx", "load_nnx_state"]


def flatten_nnx(pure: tp.Mapping, prefix: str = "") -> tp.Dict[str, np.ndarray]:
    """Dotted path -> float32 array for every parameter leaf (rng state and
    non-float leaves skipped)."""
    out: tp.Dict[str, np.ndarray] = {}
    for k, v in pure.items():
        key = f"{prefix}{k}"
        if str(k) == "rngs":
            continue
        if isinstance(v, tp.Mapping):
            out.update(flatten_nnx(v, key + "."))
            continue
        arr = np.asarray(v)
        if np.issubdtype(arr.dtype, np.floating) or arr.dtype.name == "bfloat16":
            out[key] = arr.astype(np.float32)
    return out


def _mapping(parent: nn.Module, child_name: str, module: nn.Module, leaf: str,
             path: str) -> tp.Tuple[str, tp.Callable[[np.ndarray], np.ndarray]]:
    """(flax leaf path, layout transform) for one port parameter."""
    ident = (lambda a: a)

    def at(name: str) -> str:
        return f"{path}.{name}" if path else name

    if isinstance(module, nn.Embedding):
        return at("embedding"), ident
    if isinstance(module, nn.LayerNorm):
        return at("scale" if leaf == "weight" else "bias"), ident
    if isinstance(module, nn.Linear):
        if isinstance(parent, MultiHeadAttention):
            if child_name == "out":
                if leaf == "weight":
                    return at("kernel"), lambda a: a.reshape(-1, a.shape[-1]).T
                return at("bias"), ident
            if leaf == "weight":
                return at("kernel"), lambda a: a.reshape(a.shape[0], -1).T
            return at("bias"), lambda a: a.reshape(-1)
        return (at("kernel"), lambda a: a.T) if leaf == "weight" \
            else (at("bias"), ident)
    if isinstance(module, (Conv1d, ConvTranspose1d)):
        return (at("kernel"), lambda a: a.transpose(2, 1, 0)) if leaf == "weight" \
            else (at("bias"), ident)
    return at(leaf), ident


def state_dict_from_nnx(module: nn.Module, pure: tp.Mapping) -> tp.Dict[str, torch.Tensor]:
    """The port module's ``state_dict`` (f32 tensors) built from a flax state."""
    flat = flatten_nnx(pure)
    mods = dict(module.named_modules())
    used = set()
    sd: tp.Dict[str, torch.Tensor] = {}
    for name, param in module.named_parameters():
        path, _, leaf = name.rpartition(".")
        parent_path, _, child = path.rpartition(".")
        src, fn = _mapping(mods.get(parent_path), child, mods[path], leaf, path)
        if src not in flat:
            raise KeyError(f"{name}: no flax parameter {src!r}")
        arr = np.ascontiguousarray(fn(flat[src]))
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{name}: flax {src} gives {arr.shape}, "
                             f"port expects {tuple(param.shape)}")
        sd[name] = torch.from_numpy(arr)
        used.add(src)
    unused = sorted(set(flat) - used)
    if unused:
        raise KeyError(f"flax parameters with no place in the port: {unused}")
    return sd


def load_nnx_state(module: nn.Module, pure: tp.Mapping) -> nn.Module:
    """Copy a flax pure dict into ``module`` (strict); returns the module."""
    sd = state_dict_from_nnx(module, pure)
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(sd[name].to(dtype=p.dtype, device=p.device))
    return module
