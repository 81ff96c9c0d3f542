"""K2, the fan statistics (``csrc/fan_stats.cu``): a particle's columns (and
its six chief deltas where a volume is marched) in, three sums out, the
lens samples read; the operations of every ray through the lens."""

TAG = "fan_stats_kernel"
COUNTER = ("photon_tpu_torch.ops.fan", "fan_stats")

FAN_OPS_PER_PAIR = {"general": 200, "thin-lens": 90, "apparent": 70}
FAN_OPS_MARCH = 25


def work(shape):
    P, R = shape["particles"], shape["rays"]
    march = bool(shape.get("march"))
    pair = FAN_OPS_PER_PAIR[shape["lens"]] + (FAN_OPS_MARCH if march else 0)
    cols = 13 if march else 7
    return P * R * pair, cols * P * 4 + 2 * R * 4
