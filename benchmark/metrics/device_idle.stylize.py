"""The device's idle share of the traced window: 1 - the union of its
kernel, copy and set spans over the window's length (profiler start to
the last synchronize), in percent."""


def read(records):
    if records.get("kind") != "stylize" or "trace" not in records:
        return None
    tr = records["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
