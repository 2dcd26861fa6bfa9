"""``label_residue_share.sim``: the share of the label transfer's queried
rows that fell past both levels of the label grid to the exact 1-NN, in
percent, over all the window's rooms: 100 x the sum of
``profile["label_nn_residue_rows"]`` over the sum of
``profile["label_nn_query_rows"]``.  Nothing without queried rows."""


def read(trace):
    rooms = trace.get("rooms", [])
    rows = sum(p.get("label_nn_query_rows", 0.0) for p in rooms)
    if rows <= 0:
        return None
    return 100.0 * sum(p.get("label_nn_residue_rows", 0.0) for p in rooms) / rows
