"""solver.init_ms_per_solve: the set-up each solver call does before its
march (`SolveResult.init_seconds`: kernel loads, oracle tables, layer 0),
summed over the window's solves and divided by their count."""


def read(rec):
    init = rec.get("init_seconds")
    return 1e3 * sum(init) / len(init) if init else None
