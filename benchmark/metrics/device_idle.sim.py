"""``device_idle.sim``: the share of the traced window in which no
operation ran on the device, in percent, from ``torch.profiler``.  Nothing
without a device trace."""


def read(trace):
    dev = trace.get("device")
    if not dev or dev["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
