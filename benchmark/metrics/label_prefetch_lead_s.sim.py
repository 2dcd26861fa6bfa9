"""``label_prefetch_lead_s.sim``: how far ahead the batch driver started a
room's labels, mean over the window's rooms of the program's counter
``profile["label_prefetch_lead"]`` (seconds from the start of the room's
label prefetch to its label hand-off), 0 for a room that recorded none.
Nothing where no room has the counter."""


def read(trace):
    rooms = trace.get("rooms", [])
    if not any("label_prefetch_lead" in p for p in rooms):
        return None
    return sum(p.get("label_prefetch_lead", 0.0) for p in rooms) / len(rooms)
