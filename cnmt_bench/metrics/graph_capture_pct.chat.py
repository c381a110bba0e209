"""Share of the window the program spent capturing CUDA graphs (its own
``graphs.TOTALS["capture_s"]``, read before and after the window)."""


def read(run):
    w = run.window
    return 100.0 * w.capture_s / w.length_s
