"""The card's idle share of the traced window, %: 100 (1 - the union of
kernel, copy and memset intervals over the window from the first state's
start to the last state's end), traced run, device half."""


def read(rec):
    if rec.device["window_s"] <= 0 or rec.device["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec.device["busy_s"] / rec.device["window_s"])
