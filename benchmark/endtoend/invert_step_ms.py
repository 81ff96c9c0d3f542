"""The whole window over the inversion steps completed in it."""


def value(rec):
    return 1e3 * rec.window_s / rec.units if rec.units else None
