"""The host-side text frontend: the symbol inventory, the cleaners and
per-language g2p, `cleaned_text_to_sequence` and `clean_text` (reference:
text/__init__.py:6-18, text/cleaner.py), and BERT features (`text/bert.py`,
`text/bert_encoder.py`).

A copy of `bert_vits2_tpu/text`: the g2p modules and their `assets/` are the
JAX package's files with only the imports changed (english.py also drops a
home-directory dictionary path); tests pin each copy, and each asset by
sha256, to its original. Importing the package has no side effects:
lexicons and optional backends load on first use.
"""

from __future__ import annotations

from bert_vits2_tpu_torch.text.symbols import (
    LANGUAGE_ID_MAP,
    LANGUAGE_TONE_START_MAP,
    SYMBOL_TO_ID,
)


def cleaned_text_to_sequence(cleaned_text, tones, language):
    """Phones -> ids, tones offset per language, language ids broadcast."""
    phones = [SYMBOL_TO_ID[symbol] for symbol in cleaned_text]
    tone_start = LANGUAGE_TONE_START_MAP[language]
    tones = [t + tone_start for t in tones]
    lang_id = LANGUAGE_ID_MAP[language]
    lang_ids = [lang_id] * len(phones)
    return phones, tones, lang_ids


def clean_text(text: str, language: str):
    """text -> (norm_text, phones, tones, word2ph)."""
    from bert_vits2_tpu_torch.text.cleaner import clean_text as _clean

    return _clean(text, language)


__all__ = ["cleaned_text_to_sequence", "clean_text"]
