"""Share of the profiled slice (the window's last calls) in which no
kernel, copy or set ran on the card."""


def read(run):
    s = run.window.slice
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
