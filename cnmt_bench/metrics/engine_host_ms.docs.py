"""Host milliseconds a request spends in the engine (routing, batching,
bookkeeping): the spans around ``submit_batch`` less the spans around
the card's executor, over the requests of the window."""


def read(run):
    w = run.window
    if not w.served:
        return None
    return 1e3 * (w.engine_s - w.adapter_s) / len(w.served)
