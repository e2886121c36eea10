"""The annotator's segmentation, transcription and 5-step runner
(``speechflow_torch/annotator/{seg_generator,asr,runner}.py``) against the JAX
package's, over the repository's SRC corpus (wavs with their ``.txt`` and
``.whisper`` files):

- ``SegGenerator.process_file`` over 3 SRC wavs: the TextGrid files equal as
  text (the output directory's name aside) and the wavs sample for sample;
- ``run_audio_transcription`` with a fake recognizer: the same sidecars;
- ``runner.main`` steps 0, 1 and 4: the same ``annotation_report.json``,
  ``speaker_stats.json`` and segs; step 4 over ``tests/data/SEGS`` in place;
- ``runner.main --device cpu -vs debug --max_steps 2`` with every step over 4 SRC
  wavs, the port alone (JAX's training loop is in its slow tier): every stage's
  grids written and read back, stage 2 warm-started from stage 1's checkpoint.
  Its aligner config is the repository's with no data workers, to keep it short, and
  its experiments in ``tmp_path``;
- ``--asr whisper`` raises, naming ``transformers``."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from speechflow_torch.annotator import runner
from speechflow_torch.annotator.asr import ASRBase, run_audio_transcription
from speechflow_torch.annotator.seg_generator import SegGenerator
from speechflow_torch.io.audio import AudioChunk
from speechflow_torch.io.config import yaml_dump, yaml_load
from speechflow_torch.io.seg import AudioSeg

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
LJ = REPO / "tests" / "data" / "SRC" / "EN" / "OPENSOURCE_VOICES" / "001_LJSpeech" / \
    "LJSpeech-1.1" / "wavs"
SEGS = REPO / "tests" / "data" / "SEGS"


def _src_copy(dst: Path, n: int) -> Path:
    """The first ``n`` LJSpeech wavs of SRC with their ``.txt`` and ``.whisper``."""
    dst.mkdir(parents=True)
    for wav in sorted(LJ.glob("*.wav"))[:n]:
        for ext in (".wav", ".txt", ".whisper"):
            shutil.copy(wav.with_suffix(ext), dst / wav.with_suffix(ext).name)
    return dst


def _outputs(root: Path, base: Path = None) -> dict:
    """Relative path -> text (``base``'s path, default ``root``'s, replaced), or a
    wav's samples."""
    out = {}
    for p in sorted(root.rglob("*")):
        if p.suffix == ".wav":
            out[str(p.relative_to(root))] = AudioChunk(file_path=p).load().waveform
        elif p.is_file():
            out[str(p.relative_to(root))] = p.read_text(encoding="utf-8").replace(
                str(base or root), "<root>")
    return out


def _same_outputs(ours: dict, ref: dict) -> None:
    assert set(ours) == set(ref) and ours
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(ours[k], v, err_msg=k)
        else:
            assert ours[k] == v, k


def test_seg_generator_matches_jax(tmp_path):
    from speechflow_tpu.annotator.asr import FileASR as JFileASR
    from speechflow_tpu.annotator.seg_generator import SegGenerator as JSegGenerator

    from speechflow_torch.annotator.asr import FileASR

    src = _src_copy(tmp_path / "src", 3)
    # the first text cut into sentences of 5 words, so that utterances group
    words = (src / "LJ001-0001.txt").read_text().split()
    texts = [" ".join(w + ("." if i % 5 == 4 else "") for i, w in enumerate(words)), None, None]
    for gen, sub in ((SegGenerator(asr=FileASR(), max_duration=4.0), "port"),
                     (JSegGenerator(asr=JFileASR(), max_duration=4.0), "jax")):
        start = 0
        for wav, text in zip(sorted(src.glob("*.wav")), texts):
            start += len(gen.process_file(wav, text=text, out_dir=tmp_path / sub,
                                          start_index=start))
    ours, ref = _outputs(tmp_path / "port"), _outputs(tmp_path / "jax")
    _same_outputs(ours, ref)
    assert sum(k.endswith(".TextGrid") for k in ours) > 3  # the first wav gives several
    seg = AudioSeg.load(tmp_path / "port" / "0.TextGrid")
    assert seg.lang == "EN" and seg.words()[0][2].lower().startswith("printing")
    assert seg.meta["sent_position"] == "first" and "orig" in seg.grid


class _FakeASR:
    """A transcript of the file's name and length."""

    def __call__(self, path):
        n = AudioChunk(file_path=path).duration
        return {"text": Path(path).stem, "timestamps": [[Path(path).stem, 0.0, n]]}


def test_run_audio_transcription_matches_jax(tmp_path):
    from speechflow_tpu.annotator.asr import ASRBase as JASRBase
    from speechflow_tpu.annotator.asr import run_audio_transcription as jrun

    class Ours(_FakeASR, ASRBase):
        pass

    class Theirs(_FakeASR, JASRBase):
        pass

    trees = []
    for fn, asr, sub in ((run_audio_transcription, Ours(), "port"), (jrun, Theirs(), "jax")):
        src = _src_copy(tmp_path / sub, 3)
        (src / "LJ001-0001.whisper").unlink()
        (src / "LJ001-0002.whisper").write_text("kept")
        assert fn(src, asr=asr) == 3
        assert fn(src, asr=asr, overwrite=True) == 3
        trees.append(_outputs(src))
    _same_outputs(*trees)
    assert json.loads(trees[0]["LJ001-0002.whisper"])["text"] == "LJ001-0002"


def test_runner_report_and_stats_match_jax(tmp_path):
    """Steps 0, 1 and 4 over 3 SRC wavs, then step 4 over SEGS's 50 stage-3 grids
    (aligned in place: no ``SEGS`` in the output)."""
    from speechflow_tpu.annotator import runner as jrunner

    outs = []
    for main, sub in ((runner.main, "port"), (jrunner.main, "jax")):
        src = _src_copy(tmp_path / sub / "src", 3)
        report = main(["-d", str(src), "-o", str(tmp_path / sub / "out"), "--steps", "0", "1",
                       "4"])
        stats = main(["-d", str(SEGS), "-o", str(tmp_path / sub / "stats"), "--steps", "4"])
        outs.append((report, stats, _outputs(tmp_path / sub / "out", tmp_path / sub),
                     _outputs(tmp_path / sub / "stats")))
    assert outs[0][:2] == outs[1][:2]
    _same_outputs(outs[0][2], outs[1][2])
    _same_outputs(outs[0][3], outs[1][3])
    assert outs[0][0]["transcribed"] == 3 and outs[0][0]["segs"] >= 3
    assert sum(s["n"] for s in outs[0][1]["speakers"].values()) == 50


def test_runner_every_step_on_the_cpu(tmp_path):
    src = _src_copy(tmp_path / "src", 4)
    cfg = yaml_load((REPO / "configs" / "aligner_model.yml").read_text())
    cfg["data_loaders"]["n_workers"] = 0
    cfg["experiment"]["base_dir"] = str(tmp_path / "exp")
    (tmp_path / "aligner_model.yml").write_text(yaml_dump(cfg))
    out = tmp_path / "out"
    report = runner.main(["-d", str(src), "-o", str(out), "--device", "cpu", "-vs", "debug",
                          "--max_steps", "2", "--aligner_config",
                          str(tmp_path / "aligner_model.yml")])
    assert json.loads((out / "annotation_report.json").read_text()) == report
    assert report["transcribed"] == 4 and report["segs"] >= 4
    for stage, key in ((1, "stage1_aligned"), (2, "stage2_aligned"), (3, "stage3")):
        grids = sorted((out / "SEGS").glob(f"*.TextGridStage{stage}"))
        assert len(grids) == report[key] > 0
        for g in grids:
            seg = AudioSeg.load(g)
            times = np.asarray([iv[:2] for iv in seg.phonemes()])
            assert len(times) and (np.diff(times[:, 0]) >= 0).all()
            assert times[-1, 1] <= seg.duration + 1e-6
    stats = json.loads((out / "speaker_stats.json").read_text())
    assert stats == report["speakers"] and stats["src"]["n"] == report["stage3"]
    e1, e2 = sorted((tmp_path / "exp").iterdir())
    ckpt1 = sorted((e1 / "checkpoints").iterdir())[-1]
    assert yaml_load((e2 / "model.yml").read_text())["warmstart"]["ckpt"] == str(ckpt1)
    assert ".TextGridStage1" in (e2 / "data.yml").read_text()
    assert "add_pauses_from_text" in (e1 / "data.yml").read_text()


@pytest.mark.parametrize("flag", [["--asr", "whisper"], ["--use_whisper"]])
def test_whisper_raises_naming_transformers(flag, tmp_path):
    with pytest.raises(NotImplementedError, match="transformers"):
        runner.main(["-d", str(tmp_path), "-o", str(tmp_path / "out"), "--steps", "0", *flag])


def test_experiments_started_in_the_same_second_get_their_own_directories(tmp_path):
    """The runner's two stages share a base directory; JAX names an experiment by
    its start second alone, so two in one second would share one (ROADMAP §3)."""
    from speechflow_torch.training.saver import ExperimentSaver

    paths = [ExperimentSaver(tmp_path, "aligner_stage1").expr_path for _ in range(3)]
    assert len(set(paths)) == 3 and all(p.is_dir() for p in paths)
    assert sorted(paths) == paths
