"""The card's memory in use at its peak over the window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``), GiB."""


def read(s: dict):
    peak = s.get("peak_window_bytes")
    return None if peak is None else peak / 2**30
