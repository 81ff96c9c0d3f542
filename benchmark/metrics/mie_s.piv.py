"""Seconds a case in ``run_piv``'s ``mie`` phase (its ``PhaseTimer``): the
Mie table built on the host."""


def read(reading):
    mie = reading.phases.get("mie")
    if not mie or not reading.requests:
        return None
    return mie / reading.requests
