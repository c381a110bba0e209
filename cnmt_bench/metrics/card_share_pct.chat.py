"""Share of the window's requests the engine ran on the card (the rest on
the modelled edge)."""


def read(run):
    w = run.window
    if not w.served:
        return None
    return 100.0 * sum(s.device == w.card_index for s in w.served) \
        / len(w.served)
