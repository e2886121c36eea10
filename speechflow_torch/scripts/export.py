"""Relocatable inference bundle: trained checkpoints packed into one archive
(counterpart of ``speechflow_tpu/scripts/export.py``, with the same
manifest format: a bundle either package packed loads in the other's
``InferenceBundle``).

Pack::

    speechflow-torch-export --tts <experiment-or-ckpt-dir> \\
        [--vocoder <dir>] [--prosody <dir>] [--xtts <dir>] [--g2p g2p.pkl] \\
        -o bundle.sftpu.tar.gz

Load (on the GPU unless ``device="cpu"``)::

    from speechflow_torch.scripts.export import InferenceBundle
    b = InferenceBundle.load("bundle.sftpu.tar.gz")
    audio = b.synthesize("Hello world!", lang="EN")

Each component is a ``step_*`` directory of either package's trainers: the
port's (``model.npz``, ``payload.pkl``) or the JAX trainer's orbax checkpoint,
both read by ``training.saver.ExperimentSaver.load_checkpoint``. A ``prosody``
component goes to ``TTSEvaluationInterface(prosody_ckpt=...)``, which serves
it beside the TTS model.
"""

from __future__ import annotations

import argparse
import json
import logging
import shutil
import tarfile
import tempfile
import time
import typing as tp
from pathlib import Path

import torch

from speechflow_torch.training.saver import ExperimentSaver

LOGGER = logging.getLogger("speechflow_torch")

__all__ = ["MANIFEST", "FORMAT", "KINDS", "pack", "InferenceBundle", "main", "cli"]

MANIFEST = "manifest.json"
FORMAT = "speechflow-tpu-bundle-v1"
KINDS = ("tts", "vocoder", "prosody", "xtts")


def _resolve_ckpt(path: tp.Union[str, Path]) -> Path:
    """An experiment directory, its ``checkpoints`` directory, or a ``step_*`` one."""
    p = Path(path)
    if p.name.startswith("step_") and p.is_dir():
        return p
    last = ExperimentSaver.get_last_checkpoint(p)
    if last is None:
        raise FileNotFoundError(f"no step_* checkpoint under {p}")
    return last


def _discover_g2p(ckpt: Path) -> tp.Optional[Path]:
    for c in (ckpt / "g2p.pkl", ckpt.parent / "g2p.pkl", ckpt.parent.parent / "g2p.pkl"):
        if c.is_file():
            return c
    return None


def pack(out: tp.Union[str, Path], tts: tp.Optional[tp.Union[str, Path]] = None,
         vocoder: tp.Optional[tp.Union[str, Path]] = None,
         prosody: tp.Optional[tp.Union[str, Path]] = None,
         xtts: tp.Optional[tp.Union[str, Path]] = None,
         g2p: tp.Optional[tp.Union[str, Path]] = None) -> Path:
    """Copy each component's ``step_*`` directory into a staging tree and tar
    it: ``<kind>/step_XXXX/...``, ``<kind>/g2p.pkl`` beside a TTS or XTTS
    checkpoint (where the TTS interface looks for it), and ``manifest.json``.
    The archive is a gzip stream of stored blocks: float32 weights shrink by
    well under a tenth at any zlib level, and zlib takes them at tens of MB/s,
    so compressing a bundle of full-size models costs minutes for nothing."""
    comps = {k: v for k, v in
             {"tts": tts, "vocoder": vocoder, "prosody": prosody, "xtts": xtts}.items()
             if v is not None}
    if not comps:
        raise ValueError("nothing to pack: pass at least one checkpoint")
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="sftorch_export_") as td:
        stage = Path(td) / "bundle"
        stage.mkdir()
        manifest: tp.Dict[str, tp.Any] = {"format": FORMAT,
                                          "created": time.strftime("%Y-%m-%d %H:%M:%S"),
                                          "components": {}}
        for kind, src in comps.items():
            ckpt = _resolve_ckpt(src)
            shutil.copytree(ckpt, stage / kind / ckpt.name)
            manifest["components"][kind] = f"{kind}/{ckpt.name}"
            if kind in ("tts", "xtts"):
                g2p_src = Path(g2p) if g2p else _discover_g2p(ckpt)
                if g2p_src is not None and g2p_src.is_file():
                    shutil.copy(g2p_src, stage / kind / "g2p.pkl")
                    manifest["components"][f"{kind}_g2p"] = f"{kind}/g2p.pkl"
        (stage / MANIFEST).write_text(json.dumps(manifest, indent=2))
        with tarfile.open(out, "w:gz", compresslevel=0) as tf:
            for p in sorted(stage.rglob("*")):
                tf.add(p, arcname=str(p.relative_to(stage)), recursive=False)
    LOGGER.info("packed %s -> %s (%.1f MB)", sorted(comps), out, out.stat().st_size / 1e6)
    return out


class InferenceBundle:
    """A loaded bundle: builds the eval interfaces it holds at first use, on
    ``device`` (the GPU unless ``device="cpu"``), in float32."""

    def __init__(self, root: Path, manifest: dict,
                 device: tp.Union[str, torch.device, None] = None):
        self.root = root
        self.manifest = manifest
        self.device = device
        self._cache: tp.Dict[str, tp.Any] = {}

    @classmethod
    def load(cls, path: tp.Union[str, Path], workdir: tp.Optional[tp.Union[str, Path]] = None,
             device: tp.Union[str, torch.device, None] = None) -> "InferenceBundle":
        """``path``: the archive or an extracted directory. An archive is
        extracted under ``workdir`` (default: a sibling directory named after
        it, reused when it holds a manifest)."""
        p = Path(path)
        if p.is_dir():
            root = p
        else:
            root = Path(workdir) if workdir else p.parent / (p.name.split(".")[0] + ".d")
            if not (root / MANIFEST).exists():
                root.mkdir(parents=True, exist_ok=True)
                with tarfile.open(p, "r:gz") as tf:
                    tf.extractall(root, filter="data")
        manifest = json.loads((root / MANIFEST).read_text())
        if manifest.get("format") != FORMAT:
            raise ValueError(f"not a speechflow bundle: {path}")
        return cls(root, manifest, device)

    def _ckpt(self, kind: str) -> Path:
        rel = self.manifest["components"].get(kind)
        if rel is None:
            raise KeyError(f"bundle has no {kind!r} component "
                           f"(has: {sorted(self.manifest['components'])})")
        return self.root / rel

    @property
    def tts(self):
        if "tts" not in self._cache:
            from speechflow_torch.interface.tts_interface import TTSEvaluationInterface

            ckpt = self._ckpt("tts")
            prosody = (self._ckpt("prosody")
                       if "prosody" in self.manifest["components"] else None)
            self._cache["tts"] = TTSEvaluationInterface.from_checkpoint(
                *ExperimentSaver.load_checkpoint(ckpt), ckpt_path=ckpt, device=self.device,
                prosody_ckpt=prosody)
        return self._cache["tts"]

    @property
    def vocoder(self):
        if "vocoder" not in self._cache:
            from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface

            self._cache["vocoder"] = VocoderEvaluationInterface.from_checkpoint(
                *ExperimentSaver.load_checkpoint(self._ckpt("vocoder")), device=self.device)
        return self._cache["vocoder"]

    @property
    def xtts(self):
        if "xtts" not in self._cache:
            from speechflow_torch.interface.xtts_interface import XTTSEvaluationInterface

            self._cache["xtts"] = XTTSEvaluationInterface(self._ckpt("xtts"), device=self.device)
        return self._cache["xtts"]

    def synthesize(self, text: str, lang: str = "EN", speaker: tp.Optional[str] = None,
                   opts=None):
        """Text -> mel (TTS) -> waveform (vocoder), an ``AudioChunk``: the
        sentences' valid frames in order, one vocoder call. Needs both
        components; ``.tts`` alone gives the mel."""
        iface = self.tts
        speaker = speaker or (iface.get_speakers() or [None])[0]
        out = iface.synthesize(text, lang=lang, speaker=speaker, opts=opts)
        mels, lens = out.after_postnet_spectrogram, out.spectrogram_lengths.tolist()
        return self.vocoder.synthesize(torch.cat([mels[j, :n] for j, n in enumerate(lens)]))


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for kind in KINDS:
        p.add_argument(f"--{kind}", default=None, help=f"{kind} experiment / checkpoint dir")
    p.add_argument("--g2p", default=None, help="explicit g2p.pkl (else found beside the "
                                               "checkpoint)")
    p.add_argument("-o", "--out", default="bundle.sftpu.tar.gz")
    args = p.parse_args(argv)
    out = pack(args.out, tts=args.tts, vocoder=args.vocoder, prosody=args.prosody,
               xtts=args.xtts, g2p=args.g2p)
    print(out)
    return str(out)


def cli() -> None:
    main()


if __name__ == "__main__":
    main()
