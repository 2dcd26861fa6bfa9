"""``label_join_wait_s.sim``: the wait for the room's label prefetch to
finish, mean over the window's rooms of ``profile["label_bg_join_wait"]``
(seconds), 0 for a room that recorded none."""


def read(trace):
    rooms = trace.get("rooms", [])
    if not rooms:
        return None
    return sum(p.get("label_bg_join_wait", 0.0) for p in rooms) / len(rooms)
