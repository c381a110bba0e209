"""Row-steps the card decoded past a row's own output length, over all
row-steps it decoded (a block runs to its longest member)."""


def read(run):
    blocks = run.window.blocks
    total = sum(b.rows * b.steps for b in blocks)
    if not total:
        return None
    useful = sum(sum(b.out_lens) for b in blocks)
    return 100.0 * (total - useful) / total
