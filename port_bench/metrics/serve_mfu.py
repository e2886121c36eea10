"""serve_mfu: the model operations of the traced calls over the valid tokens and
frames (``roofline.acoustic_ops`` + ``roofline.vocoder_ops``), over the traced
window times the configuration dtype's peak, in %."""

from port_bench import roofline


def read(layer: dict):
    tr, calls = layer.get("trace"), layer.get("traced_calls")
    if tr is None or not calls or tr.window_s <= 0:
        return None
    cfg = layer["config"]
    ops = sum(roofline.acoustic_ops(cfg["acoustic_model"], tokens, frames)
              + roofline.vocoder_ops(cfg["vocoder"], float(sum(frames)))
              for tokens, frames in calls)
    return 100.0 * ops / (tr.window_s * roofline.PEAK_OPS[cfg["dtype"]])
