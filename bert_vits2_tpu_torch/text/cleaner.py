"""Language routing (reference: text/cleaner.py:1-27)."""

from __future__ import annotations

from bert_vits2_tpu_torch.text import english, japanese, mandarin

LANGUAGE_MODULE_MAP = {"ZH": mandarin, "JP": japanese, "EN": english}


def clean_text(text: str, language: str):
    """text -> (norm_text, phones, tones, word2ph)."""
    module = LANGUAGE_MODULE_MAP[language]
    norm_text = module.text_normalize(text)
    phones, tones, word2ph = module.g2p(norm_text)
    return norm_text, phones, tones, word2ph


def text_to_sequence(text: str, language: str):
    from bert_vits2_tpu_torch.text import cleaned_text_to_sequence

    norm_text, phones, tones, word2ph = clean_text(text, language)
    return cleaned_text_to_sequence(phones, tones, language)
