"""anti_alias_roofline.serve: the anti-aliased snakes' share of their roofline in
the traced window, in %: the least time of every activation of the vocoder's
head over the valid frames of the traced calls (``roofline.head_activation_bound_s``:
each input read once, each output written once), over the device time of the
kernels named below (the fused entry, stage 1 and snake + stage 2 are one
template)."""

from port_bench import roofline

KERNELS = ("aa_kernel",)


def read(layer: dict):
    tr, calls = layer.get("trace"), layer.get("traced_calls")
    if tr is None or not calls:
        return None
    device_s = tr.kernel_s(KERNELS)
    if device_s <= 0:
        return None
    voc = layer["config"]["vocoder"]
    frames = sum(sum(f) for _, f in calls)
    bound = roofline.head_activation_bound_s(
        frames, voc["upsample_rates"], voc["upsample_channels"],
        len(voc["resblock_kernel_sizes"]), 3, layer["config"]["dtype"])
    return 100.0 * bound / device_s
