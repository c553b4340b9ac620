"""peak_mem_gib: the device's peak allocated memory over the window
(``max_memory_allocated`` after ``reset_peak_memory_stats`` at its
start), GiB."""


def read(rd):
    if not rd.mem_window_bytes:
        return None
    return rd.mem_window_bytes / 2**30
