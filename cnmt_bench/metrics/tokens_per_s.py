"""Output tokens of the requests the card completed in the window, each at
its own length (never at the padding of its block), over the window's
wall time."""


def read(run):
    w = run.window
    tokens = sum(s.m for s in w.served if s.device == w.card_index)
    return tokens / w.length_s if tokens else None
