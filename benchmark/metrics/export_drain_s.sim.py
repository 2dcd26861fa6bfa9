"""``export_drain_s.sim``: the batch driver's wait for a room's export to
drain, mean over the window's rooms of the program's span
``profile["export_drain"]`` (seconds), 0 for a room that recorded none.
Nothing where no room has the span."""


def read(trace):
    rooms = trace.get("rooms", [])
    if not any("export_drain" in p for p in rooms):
        return None
    return sum(p.get("export_drain", 0.0) for p in rooms) / len(rooms)
