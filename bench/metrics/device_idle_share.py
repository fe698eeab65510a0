"""Share of the traced window in which no kernel, copy or set ran on the device."""


def read(rec):
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"]) if rec["busy_s"] > 0 else None
