"""device_idle_pct: the share of the traced segment, in %, in which no kernel,
copy or fill ran on the device.  Read from the device trace; moves rounds_per_s (as
``<name>.lm``, rounds_per_s.lm in the decoder cells)."""


def read(view):
    if view.cell.get("device") != "cuda" or view.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
