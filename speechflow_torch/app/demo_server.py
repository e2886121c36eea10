"""TTS demo web app on the port (counterpart of ``app/demo_server.py``): a
stdlib HTTP server that composes ``TTSEvaluationInterface`` and
``VocoderEvaluationInterface`` and answers with a WAV.

    python -m speechflow_torch.app.demo_server --tts_ckpt <dir> --vocoder_ckpt <dir> \\
        [--port 7860] [--device cpu]

Routes: ``/`` (a form), ``/synthesize?text=...&lang=...&speaker=...`` (a WAV:
each sentence through the acoustic model at ``t_out`` 512, each sentence's
valid frames through the vocoder, the waveforms concatenated), ``/info`` (the
languages and speakers as JSON), 404 for anything else. ``make_server`` builds
the server over two interfaces; ``serve_forever`` it, or run it in a thread
and ``shutdown`` it. A checkpoint directory may be a ``step_*`` directory or an
experiment directory (its last checkpoint).
"""

from __future__ import annotations

import argparse
import json
import urllib.parse
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np

__all__ = ["PAGE", "T_OUT", "make_server", "main"]

T_OUT = 512  # frames of each sentence's acoustic output

PAGE = """<!DOCTYPE html>
<html><head><title>speechflow demo</title>
<style>body{{font-family:sans-serif;max-width:640px;margin:40px auto}}
textarea{{width:100%;height:80px}}select,button{{margin:4px 0;padding:6px}}</style>
</head><body>
<h2>speechflow &mdash; TTS demo</h2>
<form action="/synthesize" method="get">
<label>Language</label> <select name="lang">{langs}</select>
<label>Speaker</label> <select name="speaker">{speakers}</select><br/>
<textarea name="text">Hello world. This is the speech synthesis demo!</textarea><br/>
<button type="submit">Synthesize</button>
</form>
</body></html>"""


def make_server(tts, voc, host: str = "127.0.0.1", port: int = 7860) -> HTTPServer:
    """An ``HTTPServer`` on (host, port) over a TTS and a vocoder interface;
    port 0 takes a free port (``server.server_address[1]``)."""
    from speechflow_torch.interface.tts_interface import TTSOptions
    from speechflow_torch.io.audio import AudioChunk

    langs = tts.get_languages() or ["EN"]
    speakers = tts.get_speakers() or ["default"]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body: bytes, content_type: str) -> None:
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            if url.path == "/":
                self._send(PAGE.format(
                    langs="".join(f"<option>{x}</option>" for x in langs),
                    speakers="".join(f"<option>{x}</option>" for x in speakers)).encode(),
                    "text/html")
            elif url.path == "/synthesize":
                q = urllib.parse.parse_qs(url.query)
                out = tts.synthesize(q.get("text", ["Hello"])[0],
                                     lang=q.get("lang", [langs[0]])[0],
                                     speaker=q.get("speaker", [speakers[0]])[0],
                                     opts=TTSOptions(t_out=T_OUT))
                mels = out.after_postnet_spectrogram
                wavs = [voc.synthesize(mels[i, :n]).waveform
                        for i, n in enumerate(out.spectrogram_lengths.tolist())]
                self._send(AudioChunk(data=np.concatenate(wavs),
                                      sr=voc.sample_rate).to_bytes(), "audio/wav")
            elif url.path == "/info":
                self._send(json.dumps({"languages": langs, "speakers": speakers}).encode(),
                           "application/json")
            else:
                self.send_response(404)
                self.end_headers()

    return HTTPServer((host, port), Handler)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="TTS demo web app")
    p.add_argument("--tts_ckpt", required=True)
    p.add_argument("--vocoder_ckpt", required=True)
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", default=None, help="cpu to run on the CPU (default: the GPU)")
    args = p.parse_args(argv)

    from speechflow_torch.interface.tts_interface import TTSEvaluationInterface
    from speechflow_torch.interface.vocoder_interface import VocoderEvaluationInterface
    from speechflow_torch.scripts.export import _resolve_ckpt
    from speechflow_torch.training.saver import ExperimentSaver
    from speechflow_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    tts_ckpt = _resolve_ckpt(args.tts_ckpt)
    tts = TTSEvaluationInterface.from_checkpoint(
        *ExperimentSaver.load_checkpoint(tts_ckpt), ckpt_path=tts_ckpt, device=device)
    voc = VocoderEvaluationInterface.from_checkpoint(
        *ExperimentSaver.load_checkpoint(_resolve_ckpt(args.vocoder_ckpt)), device=device)
    srv = make_server(tts, voc, port=args.port)
    print(f"demo at http://127.0.0.1:{srv.server_address[1]}")
    srv.serve_forever()


if __name__ == "__main__":
    main()
