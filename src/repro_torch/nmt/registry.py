"""Registry of the paper's three evaluated model/dataset combinations.

Model construction lives in :mod:`repro_torch.models.registry`
(``resolve("cnmt:en-zh")``).
"""

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
