"""L6 serving layer: text segmentation, mix markup, model registry, HTTP API
(reference: hiyoriUI.py, webui.py, re_matching.py, tools/).

Self-contained: the HTTP server is stdlib http.server (no fastapi/uvicorn in
the image), language ID is a Unicode-script classifier (no langid/fastlid).
"""

from bert_vits2_tpu_torch.serve.markup import parse_mix_text, validate_mix_text
from bert_vits2_tpu_torch.serve.registry import ModelRegistry
from bert_vits2_tpu_torch.serve.textseg import (
    classify_language,
    cut_paragraphs,
    cut_sentences,
    markup_language,
    sentence_split,
    split_by_language,
)

__all__ = [
    "parse_mix_text",
    "validate_mix_text",
    "ModelRegistry",
    "classify_language",
    "cut_paragraphs",
    "cut_sentences",
    "markup_language",
    "sentence_split",
    "split_by_language",
]
