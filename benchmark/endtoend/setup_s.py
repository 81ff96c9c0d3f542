"""Set-up: process start to the first timed request (the kernels' build on
a checkout's first run, loading, inputs made on the device, warm-up)."""


def value(rec):
    return rec.setup_s
