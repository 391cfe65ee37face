"""The mean of the solver's iteration count over the window's solves."""


def read(s: dict):
    its = s["iterations"]
    return sum(its) / len(its)
