"""K6, the fan statistics' backward (``csrc/fan_stats_bwd.cu``): the
forward recomputed and its cotangents swept back for every ray."""
from benchmark.counts.fan_fwd import FAN_OPS_MARCH, FAN_OPS_PER_PAIR

TAG = "fan_stats_bwd_kernel"
COUNTER = ("photon_tpu_torch.ops.fan", "fan_stats_backward")

FAN_BWD_OPS_PER_PAIR = {"general": 420, "thin-lens": 150, "apparent": 110}
FAN_BWD_OPS_MARCH = 35


def work(shape):
    P, R = shape["particles"], shape["rays"]
    lens = shape["lens"]
    pair = (FAN_OPS_PER_PAIR[lens] + FAN_OPS_MARCH + FAN_BWD_OPS_PER_PAIR[lens]
            + FAN_BWD_OPS_MARCH)
    return P * R * pair, 23 * P * 4 + 2 * R * 4
