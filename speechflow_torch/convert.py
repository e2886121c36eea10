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
``Conv.kernel`` (2-D)      (kh, kw, Cin, Cout)         ``Conv2d.weight`` (Cout, Cin, kh, kw)
``ConvTranspose.kernel``   (K, Cin, Cout)              correlation weight (Cout, Cin, K), unflipped
``MultiHeadAttention``     q/k/v kernel (in, H, dh),   ``Linear.weight`` (H·dh, in), bias (H·dh,);
                           bias (H, dh); out kernel    out weight (out, H·dh)
                           (H, dh, out)
``Embed.embedding``        (N, D)                      ``Embedding.weight`` (N, D)
``LayerNorm.scale/bias``   (D,)                        ``LayerNorm.weight/bias``
``GroupNorm.scale/bias``   (D,)                        ``GroupNorm.weight/bias``
bare ``Param``             any                         same name, same shape
float ``Variable``         any (CREPE's ``cents``)     a parameter without gradient
=========================  ==========================  ===========================

The copy is strict both ways: every parameter of the port must be filled
and every parameter of the JAX state used. ``lenet_state_dict`` /
``lenet_to_nnx`` do the same for the MNIST example's LeNet, whose port is NCHW
where JAX's is NHWC: besides the layouts above, the first dense layer's input
rows go from JAX's (H, W, C) flattening to the port's (C, H, W).
``nnx_from_module`` is the
inverse: the port's parameters as the JAX package's pure dict (nested dicts
of float32 numpy, list indices as ints), which ``nnx.replace_by_pure_dict``
takes. This module is the only bridge between the packages, and it takes
plain arrays: it imports neither.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch
import torch.nn as nn

from speechflow_torch.models.layers import Conv1d, Conv2d, ConvTranspose1d, MultiHeadAttention

__all__ = ["flatten_nnx", "state_dict_from_nnx", "load_nnx_state", "nnx_path", "jax_layouts",
           "nnx_from_module", "lenet_state_dict", "lenet_to_nnx"]


def flatten_nnx(pure: tp.Mapping, prefix: str = "") -> tp.Dict[str, np.ndarray]:
    """Dotted path -> float32 array for every parameter leaf (rng state and
    non-float leaves skipped; a torch tensor leaf, as a bfloat16 array of an
    orbax checkpoint reads, is taken as its float32 values)."""
    out: tp.Dict[str, np.ndarray] = {}
    for k, v in pure.items():
        key = f"{prefix}{k}"
        if str(k) == "rngs":
            continue
        if isinstance(v, tp.Mapping):
            out.update(flatten_nnx(v, key + "."))
            continue
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            v = v.float() if v.is_floating_point() else v
        arr = np.asarray(v)
        if np.issubdtype(arr.dtype, np.floating) or arr.dtype.name == "bfloat16":
            out[key] = arr.astype(np.float32)
    return out


Layout = tp.Callable[[tp.Any], tp.Any]


def _perm(a, axes: tp.Sequence[int]):
    """``a`` with its axes in the order ``axes`` (a numpy array or a tensor)."""
    return a.permute(*axes) if isinstance(a, torch.Tensor) else a.transpose(axes)


def _mapping(parent: nn.Module, child_name: str, module: nn.Module, leaf: str,
             path: str) -> tp.Tuple[str, Layout, Layout]:
    """(flax leaf path, flax -> port layout, port -> flax layout) for one port
    parameter; the layouts take numpy arrays and tensors alike."""
    ident = (lambda a: a)

    def at(name: str) -> str:
        return f"{path}.{name}" if path else name

    if isinstance(module, nn.Embedding):
        return at("embedding"), ident, ident
    if isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
        return at("scale" if leaf == "weight" else "bias"), ident, ident
    if isinstance(module, nn.Linear):
        if isinstance(parent, MultiHeadAttention):
            h, dh = parent.n_heads, parent.head_dim
            if child_name == "out":
                if leaf == "weight":
                    return (at("kernel"), lambda a: a.reshape(-1, a.shape[-1]).T,
                            lambda w: w.T.reshape(h, dh, -1))
                return at("bias"), ident, ident
            if leaf == "weight":
                return (at("kernel"), lambda a: a.reshape(a.shape[0], -1).T,
                        lambda w: w.T.reshape(-1, h, dh))
            return at("bias"), lambda a: a.reshape(-1), lambda w: w.reshape(h, dh)
        return (at("kernel"), lambda a: a.T, lambda w: w.T) if leaf == "weight" \
            else (at("bias"), ident, ident)
    if isinstance(module, (Conv1d, ConvTranspose1d)):
        t = (lambda a: _perm(a, (2, 1, 0)))
        return (at("kernel"), t, t) if leaf == "weight" else (at("bias"), ident, ident)
    if isinstance(module, Conv2d):
        return (at("kernel"), lambda a: _perm(a, (3, 2, 0, 1)),
                lambda w: _perm(w, (2, 3, 1, 0))) if leaf == "weight" \
            else (at("bias"), ident, ident)
    return at(leaf), ident, ident


def _mappings(module: nn.Module):
    """(port name, parameter, flax path, to port, to flax) for every parameter."""
    mods = dict(module.named_modules())
    for name, param in module.named_parameters():
        path, _, leaf = name.rpartition(".")
        parent_path, _, child = path.rpartition(".")
        yield (name, param, *_mapping(mods.get(parent_path), child, mods[path], leaf, path))


def nnx_path(module: nn.Module) -> tp.Dict[str, str]:
    """Port parameter name -> its path in the JAX layout, ``/``-joined (the path
    optax's param-group labels match)."""
    return {name: src.replace(".", "/") for name, _, src, _, _ in _mappings(module)}


def jax_layouts(module: nn.Module) -> tp.Dict[str, tp.Tuple[str, Layout, Layout]]:
    """Port parameter name -> (its dotted flax path, port -> flax layout, flax ->
    port layout), each layout a function of a tensor (or numpy array)."""
    return {name: (src, to_flax, to_port)
            for name, _, src, to_port, to_flax in _mappings(module)}


def nnx_from_module(module: nn.Module) -> dict:
    """The inverse of ``state_dict_from_nnx``: the port module's parameters as
    the JAX package's pure dict, float32 numpy leaves."""
    out: dict = {}
    for _, param, src, _, to_flax in _mappings(module):
        node = out
        keys = [int(k) if k.isdigit() else k for k in src.split(".")]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        arr = param.detach().to("cpu", torch.float32).numpy()
        node[keys[-1]] = np.ascontiguousarray(to_flax(arr))
    return out


def state_dict_from_nnx(module: nn.Module, pure: tp.Mapping) -> tp.Dict[str, torch.Tensor]:
    """The port module's ``state_dict`` (f32 tensors) built from a flax state."""
    flat = flatten_nnx(pure)
    used = set()
    sd: tp.Dict[str, torch.Tensor] = {}
    for name, param, src, fn, _ in _mappings(module):
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


def _lenet_map(channels: int, rows: int) -> tp.Tuple[int, int, int]:
    """(H, W, C) of the square map ``l1`` flattens: ``rows`` = H·W·C."""
    side = math.isqrt(rows // channels)
    return side, side, channels


def lenet_state_dict(pure: tp.Mapping) -> tp.Dict[str, torch.Tensor]:
    """The LeNet's ``state_dict`` (convs ``c1``, ``c2``; dense ``l1``, ``l2``) from
    JAX's pure dict: conv kernels (kh, kw, Cin, Cout) -> (Cout, Cin, kh, kw), dense
    kernels transposed, and ``l1``'s rows, flattened from ``c2``'s square (H, W, C)
    map, reordered to (C, H, W)."""
    flat = flatten_nnx(pure)
    expect = {f"{m}.{leaf}" for m in ("c1", "c2", "l1", "l2") for leaf in ("kernel", "bias")}
    if set(flat) != expect:
        raise KeyError(f"a LeNet state has {sorted(expect)}, got {sorted(flat)}")
    l1 = flat["l1.kernel"]
    h, w, c = _lenet_map(flat["c2.kernel"].shape[-1], l1.shape[0])
    arrays = {
        "c1.weight": flat["c1.kernel"].transpose(3, 2, 0, 1),
        "c2.weight": flat["c2.kernel"].transpose(3, 2, 0, 1),
        "l1.weight": l1.reshape(h, w, c, -1).transpose(2, 0, 1, 3).reshape(h * w * c, -1).T,
        "l2.weight": flat["l2.kernel"].T,
    }
    arrays.update({f"{m}.bias": flat[f"{m}.bias"] for m in ("c1", "c2", "l1", "l2")})
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}


def lenet_to_nnx(module: nn.Module) -> dict:
    """The inverse of ``lenet_state_dict``: the port's LeNet as JAX's pure dict."""
    sd = {k: v.detach().to("cpu", torch.float32).numpy() for k, v in module.state_dict().items()}
    l1 = sd["l1.weight"].T
    h, w, c = _lenet_map(sd["c2.weight"].shape[0], l1.shape[0])
    kernels = {
        "c1": sd["c1.weight"].transpose(2, 3, 1, 0),
        "c2": sd["c2.weight"].transpose(2, 3, 1, 0),
        "l1": l1.reshape(c, h, w, -1).transpose(1, 2, 0, 3).reshape(h * w * c, -1),
        "l2": sd["l2.weight"].T,
    }
    return {m: {"kernel": np.ascontiguousarray(k), "bias": sd[f"{m}.bias"]}
            for m, k in kernels.items()}
