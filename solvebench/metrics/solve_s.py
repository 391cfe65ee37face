"""Time to solution: the window's seconds over the solves it completed (the
window ends with the first solve that returns after ``--seconds``)."""


def read(s: dict):
    return s["window_s"] / s["n_solves"]
