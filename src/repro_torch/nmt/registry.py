"""Registry of the paper's three evaluated model/dataset combinations.

Deprecated entry point, as in the reference: model construction lives in
:mod:`repro_torch.models.registry` (``resolve("cnmt:en-zh")``).
:func:`make_paper_model` remains as a thin shim that emits
``DeprecationWarning`` and delegates there.
"""

import warnings

# dataset -> (model family, paper hyper-params, language pair)
PAPER_MODELS = {
    # i) 2-layer BiLSTM, hidden 500, IWSLT'14 DE-EN
    "de-en": ("bilstm", dict(layers=2, hidden=500, embed=500), "de-en"),
    # ii) 1-layer GRU, hidden 256, OPUS-100 FR-EN
    "fr-en": ("gru", dict(layers=1, hidden=256, embed=256), "fr-en"),
    # iii) MarianMT transformer, OPUS-100 EN-ZH
    "en-zh": ("marian", dict(d_model=512, heads=8, d_ff=2048,
                             enc_layers=6, dec_layers=6), "en-zh"),
}


def make_paper_model(dataset: str, *, scale: float = 1.0,
                     vocab: int = 8000, max_decode_len: int = 256,
                     device=None):
    """Deprecated alias for ``repro_torch.models.registry.resolve(
    f"cnmt:{dataset}", ...)``; returns the legacy ``(model, pair)`` tuple.
    The reference's ``attn_impl`` has no counterpart (the port's models
    pick the kernels by device); ``device`` is ``resolve``'s (``cuda``
    unless ``"cpu"``)."""
    warnings.warn(
        "make_paper_model is deprecated; use "
        "repro_torch.models.registry.resolve('cnmt:<pair>', ...)",
        DeprecationWarning, stacklevel=2)
    from repro_torch.models.registry import resolve
    r = resolve(f"cnmt:{dataset}", scale=scale, vocab=vocab,
                max_decode_len=max_decode_len, device=device)
    return r.model, r.pair
