"""``pipeline_rooms_per_h``: rooms that the five-stage pipeline finished in the window, over
the window's wall clock (from its start to the end of its last call), per
hour.  Whole rooms over the whole window: a stall anywhere counts."""


def value(run):
    if run["window_s"] <= 0:
        return None
    return run["rooms_done"] / run["window_s"] * 3600.0
