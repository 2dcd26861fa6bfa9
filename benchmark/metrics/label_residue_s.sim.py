"""``label_residue_s.sim``: the exact 1-NN of the rows the label grid left,
mean over the window's rooms of the program's span
``profile["label_nn_residue"]`` (seconds), 0 for a room that recorded none.
Nothing where no room has the span."""


def read(trace):
    rooms = trace.get("rooms", [])
    if not any("label_nn_residue" in p for p in rooms):
        return None
    return sum(p.get("label_nn_residue", 0.0) for p in rooms) / len(rooms)
