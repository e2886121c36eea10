"""attention_roofline.serve: the attention kernels' share of their roofline in
the traced window, in %: the sum over the attention calls the traced calls
need (the encoder's layers over the valid tokens, the CFM estimator's layers at
every Euler step over the valid frames, doubled by batched CFG) of each call's
least time (``roofline.attention_bound_s``, valid rows x valid keys), over the
device time of the kernels named below."""

from port_bench import roofline

KERNELS = ("attn_fwd_kernel", "attn_fwd_tf32_kernel")


def read(layer: dict):
    tr, calls = layer.get("trace"), layer.get("traced_calls")
    if tr is None or not calls:
        return None
    device_s = tr.kernel_s(KERNELS)
    if device_s <= 0:
        return None
    cfg = layer["config"]["acoustic_model"]
    dtype = layer["config"]["dtype"]
    enc_dh = cfg["encoder_dim"] // cfg["encoder_heads"]
    dec_dh = cfg["decoder_dim"] // cfg["decoder_heads"]
    cfg_x = 2 if cfg.get("cfm_cfg_scale", 0.0) > 0 else 1
    bound = 0.0
    for tokens, frames in calls:
        bound += cfg["encoder_layers"] * roofline.attention_bound_s(
            cfg["encoder_heads"], enc_dh, tokens, dtype)
        bound += cfg["cfm_n_timesteps"] * cfg["decoder_layers"] * roofline.attention_bound_s(
            cfg["decoder_heads"], dec_dh, list(frames) * cfg_x, dtype)
    return 100.0 * bound / device_s
