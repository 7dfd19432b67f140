"""The part of the text frontend the training data needs: the symbol
inventory and `cleaned_text_to_sequence` (reference: text/__init__.py:6-18).

A copy of `bert_vits2_tpu/text`'s symbols and sequence mapping; a test pins
the two together. g2p, cleaners and BERT features come with later slices.
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


__all__ = ["cleaned_text_to_sequence"]
