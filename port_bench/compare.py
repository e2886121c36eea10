"""The comparisons that decide ``correct``: what the timed path produced against
the plain reference, number by number, each against the limit its workload
file states.

Serving (``serve_numbers``), for each call sampled from the window:

- ``dur_gap``: the largest gap, over valid tokens, between the program's
  log(1 + duration) predictions and the reference's from the same inputs;
- ``align_frames``: frames whose alignment differs from the rounding of the
  program's own predictions (the regulator's output, exact; limit 0);
- ``mel_err``: the largest relative RMS error over rows of the program's mel
  over valid frames against the reference's, which decodes the program's own
  alignment (so that one rounding flip of a duration cannot shift every later
  frame; the durations are held by the two numbers above);
- ``wave_err``: the same for the waveform over valid samples, the reference
  vocoder fed the program's mel.
"""

from __future__ import annotations

import contextlib
import statistics
import typing as tp

import torch

from port_bench.reference import nn as R

ROW_BLOCK = 8


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32 while the reference runs."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def rel_rms_rows(got: torch.Tensor, ref: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per row: ||got - ref|| / ||ref|| over the valid positions (valid broadcasts)."""
    m = valid.to(torch.float32)
    while m.ndim < ref.ndim:
        m = m[..., None]
    d = ((got.float() - ref.float()) ** 2 * m).flatten(1).sum(1)
    r = (ref.float() ** 2 * m).flatten(1).sum(1)
    return torch.sqrt(d / torch.clamp(r, min=1e-30))


def rows(inputs: tp.Mapping[str, torch.Tensor], lo: int, hi: int) -> dict:
    return {k: v[lo:hi] for k, v in inputs.items()}


@torch.no_grad()
def serve_numbers(prog: tp.Mapping[str, torch.Tensor], inputs: tp.Mapping[str, torch.Tensor],
                  noise: torch.Tensor, am, voc, t_out: int, hop: int,
                  prec: R.Precision = R.Precision.reference()) -> tp.Dict[str, float]:
    """The serving numbers of one call. ``prog``: the program's ``log_d`` (B, N),
    ``align`` (B, t_out, N), ``lengths`` (B,), ``mel`` (B, t_out, n_mels) and
    ``wave`` (B, S); ``inputs`` and ``noise`` on the reference's device."""
    out = {"dur_gap": 0.0, "align_frames": 0.0, "mel_err": 0.0, "wave_err": 0.0}
    b = prog["lengths"].shape[0]
    with no_tf32():
        for lo in range(0, b, ROW_BLOCK):
            hi = min(b, lo + ROW_BLOCK)
            x = rows(inputs, lo, hi)
            lens = x["transcription_lengths"]
            content, cond, log_d = am.infer(x, prec)
            tok = R.seq_mask(lens, log_d.shape[1])
            gap = (prog["log_d"][lo:hi].float() - log_d.float()).abs()[tok]
            out["dur_gap"] = max(out["dur_gap"], float(gap.max()) if gap.numel() else 0.0)
            align, out_lens = am.regulate(prog["log_d"][lo:hi], lens, t_out)
            p_align, p_lens = prog["align"][lo:hi].float(), prog["lengths"][lo:hi]
            bad = (align != p_align).any(-1).sum() + (out_lens != p_lens).sum()
            out["align_frames"] += float(bad)
            mel = am.decode(content, cond, p_align, p_lens, noise[lo:hi], prec)
            frames = R.seq_mask(p_lens, mel.shape[1])
            err = rel_rms_rows(prog["mel"][lo:hi], mel, frames)
            out["mel_err"] = max(out["mel_err"], float(err.max()))
            wave = voc.from_features(prog["mel"][lo:hi].float(), prec)
            samples = R.seq_mask((p_lens - 1).clamp(min=1) * hop, wave.shape[1])
            err = rel_rms_rows(prog["wave"][lo:hi], wave, samples)
            out["wave_err"] = max(out["wave_err"], float(err.max()))
    return out


@torch.no_grad()
def serve_control(inputs, noise, am, voc, t_out: int) -> tp.Dict[str, torch.Tensor]:
    """The reference computed in the control's precision, in the program's place:
    the same outputs the program's call gives."""
    prec = R.Precision.control()
    outs = []
    for lo in range(0, noise.shape[0], ROW_BLOCK):
        hi = min(noise.shape[0], lo + ROW_BLOCK)
        o = am(rows(inputs, lo, hi), t_out, noise[lo:hi], prec)
        o["wave"] = voc.from_features(o["mel"], prec)
        outs.append(o)
    return {k: torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}


def merge(per_call: tp.Sequence[tp.Mapping[str, float]]) -> tp.Dict[str, float]:
    """Several calls' numbers as one: frame counts add up, the rest take the largest."""
    return {k: (sum if k == "align_frames" else max)(n[k] for n in per_call)
            for k in per_call[0]}


def judge(numbers: tp.Mapping[str, float], limits: tp.Mapping[str, float]
          ) -> tp.Tuple[bool, tp.Dict[str, tp.Tuple[float, float]]]:
    """(every number within its limit, {name: (value, limit)})."""
    checks = {k: (float(numbers[k]), float(limits[k])) for k in limits}
    ok = all(v <= lim and v == v for v, lim in checks.values())
    return ok, checks


# -- training --------------------------------------------------------------------------

SNAKE = ("alpha", "beta")  # an anti-aliased snake's parameters


def leaf_norms(tree: tp.Mapping[str, torch.Tensor]) -> tp.Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tree.items()}


def worst_leaf_gap(prog: tp.Mapping[str, float], ref: tp.Mapping[str, float],
                   keep: tp.Iterable[str], med: tp.Optional[float] = None
                   ) -> tp.Tuple[float, str]:
    """(max over the kept leaves of |‖prog‖ − ‖ref‖| / max(‖ref‖, the median leaf's
    ‖ref‖), that leaf's name); the median is the kept leaves' unless given."""
    keep = list(keep)
    if med is None:
        med = float(torch.tensor([ref[k] for k in keep]).median())
    return max((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30), k) for k in keep)


def common_scale(prog: tp.Mapping[str, float], ref: tp.Mapping[str, float],
                 keep: tp.Sequence[str]) -> tp.Dict[str, float]:
    """The program's leaf norms with each network's common factor taken out: the
    median over its kept leaves of ‖prog‖ / ‖ref‖. Clipping by the global norm
    divides every gradient of a network by one number, which its few largest
    leaves set; the rounding of those would otherwise move every leaf's gap,
    and Adam's moves do not see the factor."""
    out = {}
    for net in {k.split(".", 1)[0] for k in keep}:
        ks = [k for k in keep if k.split(".", 1)[0] == net]
        s = statistics.median(prog[k] / ref[k] for k in ks)
        out.update({k: prog[k] / s for k in ks})
    return out


def kept_leaves(g_ref: tp.Mapping[str, float]) -> tp.List[str]:
    """Leaves whose reference gradient is at least a thousandth of the median
    leaf's: the others move under Adam by rounding alone."""
    med = statistics.median(g_ref.values())
    return [k for k, v in g_ref.items() if v >= 1e-3 * med]


def grad_numbers(g_prog: tp.Mapping[str, float], g_ref: tp.Mapping[str, float]) -> dict:
    """``grad_gap``, ``grad_gap_median`` and ``grad_gap_snake`` from the leaves'
    first-gradient norms, and their worst leaves under ``worst``."""
    keep = kept_leaves(g_ref)
    kept_med = statistics.median(g_ref[k] for k in keep)
    g_scaled = common_scale(g_prog, g_ref, keep)
    grad_gap, grad_leaf = worst_leaf_gap(g_scaled, g_ref, keep, kept_med)
    snake = [k for k in keep if k.startswith("generator.") and k.rsplit(".", 1)[1] in SNAKE]
    snake_gap, snake_leaf = worst_leaf_gap(g_scaled, g_ref, snake, kept_med) if snake \
        else (0.0, "")
    leaf_gaps = sorted(abs(g_scaled[k] - g_ref[k]) / max(g_ref[k], kept_med) for k in keep)
    return {"grad_gap": grad_gap, "grad_gap_median": leaf_gaps[len(leaf_gaps) // 2],
            "grad_gap_snake": snake_gap,
            "worst": {"grad": (grad_leaf, g_scaled[grad_leaf], g_ref[grad_leaf]),
                      "snake": (snake_leaf, g_scaled.get(snake_leaf), g_ref.get(snake_leaf)),
                      "median_grad": kept_med, "left_out": len(g_ref) - len(keep)}}


def train_numbers(prog: dict, ref: dict, accum: int) -> tp.Dict[str, float]:
    """The training numbers. Each side gives ``losses`` (a (gen, disc) pair a
    micro-batch of the first steps), ``first_grad`` (name -> the gradient its
    optimizer took at its first step, both networks) and ``delta`` (name -> the
    parameters' change over the first steps).

    - ``loss_gap``: the largest relative gap of a step's mean loss, either network;
    - ``delta_gap``: the worst leaf's gap of the norms of the change, over the
      ``kept_leaves``;
    - ``grad_gap``, ``grad_gap_median``: the worst and the median kept leaf's gap
      of the first gradient's norms, each network's common factor taken out
      (``common_scale``);
    - ``grad_gap_snake``: ``grad_gap`` over the generator's snake parameters
      (``alpha``, ``beta``) alone: the leaves whose gradients only the
      anti-alias VJPs make.

    A leaf's gap is measured against the larger of its reference norm and the
    median kept leaf's.
    """
    gap = 0.0
    n_steps = len(ref["losses"]) // accum
    for s in range(n_steps):
        for side in (0, 1):
            p = sum(x[side] for x in prog["losses"][s * accum:(s + 1) * accum]) / accum
            r = sum(x[side] for x in ref["losses"][s * accum:(s + 1) * accum]) / accum
            gap = max(gap, abs(p - r) / max(abs(r), 1e-30))
    g_ref, g_prog = leaf_norms(ref["first_grad"]), leaf_norms(prog["first_grad"])
    out = {"loss_gap": gap, **grad_numbers(g_prog, g_ref)}
    d_ref, d_prog = leaf_norms(ref["delta"]), leaf_norms(prog["delta"])
    out["delta_gap"], leaf = worst_leaf_gap(d_prog, d_ref, kept_leaves(g_ref))
    out["worst"]["delta"] = (leaf, d_prog[leaf], d_ref[leaf])
    return out
