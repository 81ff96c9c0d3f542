"""Images completed in the window over the window's seconds."""


def value(rec):
    return rec.units / rec.window_s if rec.window_s > 0 else None
