"""Useful FLOPs of the requests the card completed in the window (each at
its own source and output length, from the reference's count) over the
window times the card's 3 x TF32 rate (float32-accurate tensor-core
products: 495 / 3 TFLOP/s)."""


def read(run):
    w = run.window
    flops = sum(run.cell.reference.request_flops(run.widths, len(s.tokens),
                                                 s.m)
                for s in w.served if s.device == w.card_index)
    if not flops:
        return None
    return 100.0 * flops / (w.length_s * run.peaks.FP32_3XTF32_FLOPS)
