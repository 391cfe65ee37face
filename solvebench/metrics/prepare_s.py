"""The pipeline's build on the host clock, ending in a synchronise:
``prepare()`` (``optimize()``'s layout) and any preconditioner with it."""


def read(s: dict):
    return s["prepare_s"]
