"""Process start to the window's start: imports, CUDA start-up, the CSR,
the right-hand sides, the pipeline's build and one warm-up solve."""


def read(s: dict):
    return s["setup_s"]
