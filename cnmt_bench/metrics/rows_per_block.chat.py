"""Mean rows of the blocks the card ran in the window."""


def read(run):
    blocks = run.window.blocks
    return sum(b.rows for b in blocks) / len(blocks) if blocks else None
