"""Dataset parsers (counterpart of ``speechflow_tpu/data/parsers.py``): the
``AudioDSParser`` of the vocoder's data config, a file list -> audio samples
whose speaker is read from the path. Files are listed, not read: the audio is
loaded by the ``load_audio`` handler."""

from __future__ import annotations

import typing as tp
from pathlib import Path

from speechflow_torch.data.core.datasample import AudioDataSample
from speechflow_torch.io.audio import AudioChunk

__all__ = ["AudioDSParser", "PARSERS"]


class AudioDSParser:
    @staticmethod
    def speaker_from_path(p: Path) -> str:
        """The first ancestor directory that is not a numeric shard or a
        generic name (``wavs``, ``wav``, ``audio``)."""
        for parent in p.parents:
            name = parent.name
            if name and not name.isdigit() and name.lower() not in ("wavs", "wav", "audio"):
                return name
        return p.parent.name

    def to_datasample(self, path: tp.Union[str, Path]) -> AudioDataSample:
        p = Path(path)
        speaker = self.speaker_from_path(p)
        return AudioDataSample(file_path=str(p), label=speaker, speaker_name=speaker,
                               audio_chunk=AudioChunk(file_path=p))

    def read_datasamples(self, files: tp.Sequence[tp.Union[str, Path]]
                         ) -> tp.List[AudioDataSample]:
        samples = [self.to_datasample(f) for f in files]
        for i, s in enumerate(samples):
            s.index = i
        return samples


PARSERS = {"AudioDSParser": AudioDSParser}
