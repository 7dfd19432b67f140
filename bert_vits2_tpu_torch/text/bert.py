"""Word-level BERT feature extraction -> phone-level conditioning features.

Counterpart of `bert_vits2_tpu/text/bert.py` (reference:
text/chinese_bert.py:15-60, japanese_bert.py, english_bert_mock.py): a
per-language pretrained encoder, hidden_states[-3] (1024-d), each word's
vector repeated word2ph[i] times to phone resolution, optionally mixed with
a style text's mean feature at `style_weight` (V2.3 style transfer).

The extractor is pluggable: the port's own encoder on the card when local
weights exist (`text/bert_encoder.py`), or seeded noise (the reference
itself feeds randn for inactive languages, infer.py:126-137). Unlike the
JAX package, a failure to load weights that are present raises: there is
no fallback to a host-side HF model.
"""

from __future__ import annotations

import logging
import os
import warnings
from typing import Protocol

import numpy as np
import torch

logger = logging.getLogger("bert_vits2_tpu_torch")

BERT_DIM = 1024


def _asset_root() -> str:
    """Root holding the `bert/` weight directory.

    $BERT_VITS2_ASSET_ROOT wins; else a reference-style `./bert` beside the
    current working directory; else the repo root."""
    env = os.environ.get("BERT_VITS2_ASSET_ROOT")
    if env:
        return env
    if os.path.isdir(os.path.join(os.getcwd(), "bert")):
        return os.getcwd()
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


# language -> default local path (reference dir names, infer.py:34-41)
DEFAULT_BERT_PATHS = {
    "ZH": os.path.join(_asset_root(), "bert", "chinese-roberta-wwm-ext-large"),
    "JP": os.path.join(_asset_root(), "bert",
                       "deberta-v2-large-japanese-char-wwm"),
    "EN": os.path.join(_asset_root(), "bert", "deberta-v3-large"),
}


class BertExtractor(Protocol):
    def __call__(
        self,
        norm_text: str,
        word2ph: list[int],
        language: str,
        style_text: str | None = None,
        style_weight: float = 0.7,
    ) -> np.ndarray:  # [sum(word2ph), 1024]
        ...


def expand_word2ph(features: np.ndarray, word2ph: list[int]) -> np.ndarray:
    """[n_words, d] -> [n_phones, d] by repeating row i word2ph[i] times."""
    assert features.shape[0] == len(word2ph), (features.shape, len(word2ph))
    return np.repeat(features, np.asarray(word2ph), axis=0)


class RandomBertExtractor:
    """Seeded N(0,1) features — matches the reference's placeholder statistics
    for inactive languages; usable for smoke tests and BERT-free operation.
    The seed mixes in `hash(norm_text)`, which differs between processes
    unless PYTHONHASHSEED is set (as in the JAX package)."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    def __call__(self, norm_text, word2ph, language, style_text=None, style_weight=0.7):
        rng = np.random.default_rng((self.seed, hash(norm_text) & 0x7FFFFFFF))
        return rng.normal(size=(sum(word2ph), BERT_DIM)).astype(np.float32)


def weights_present(path: str) -> bool:
    """True when `path` holds a loadable HF checkpoint (config + weights)."""
    return (
        os.path.isdir(path)
        and os.path.isfile(os.path.join(path, "config.json"))
        and any(
            os.path.isfile(os.path.join(path, f))
            for f in ("model.safetensors", "pytorch_model.bin")
        )
    )


class AutoBertExtractor:
    """Default engine extractor: real per-language BERT features whenever
    local weights exist, noise only as an explicit degraded mode.

      - language has weights under `paths[lang]` -> the port's encoder
        (`BertEncoderExtractor`) on `device`; a load failure raises;
      - no weights -> `allow_noise=True` (default) emits a loud once-per-
        language warning and substitutes seeded noise; `allow_noise=False`
        raises instead, at construction and again at resolution.

    Resolution is lazy (first call per language) so engine construction
    stays cheap; `describe()` reports the backend per language ("torch" or
    "noise") without touching the weights.
    """

    def __init__(
        self,
        paths: dict | None = None,
        allow_noise: bool = True,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        self.paths = dict(DEFAULT_BERT_PATHS)
        if paths:
            self.paths.update(paths)
        self.allow_noise = allow_noise
        self.device = device
        self._noise = RandomBertExtractor(seed)
        self._real: dict = {}  # language -> (backend_name, extractor|None)
        self._shared = None
        if not allow_noise:
            missing = [
                f"{lang} ({path!r})"
                for lang, path in sorted(self.paths.items())
                if not weights_present(path)
            ]
            if missing:
                raise FileNotFoundError(
                    "allow_noise=False but local BERT weights are missing "
                    f"for: {', '.join(missing)}; run `python -m "
                    "bert_vits2_tpu.tools.fetch_assets --fetch` "
                    "(docs/WEIGHTS.md)"
                )

    def describe(self) -> dict[str, str]:
        """language -> backend name ("torch"/"noise"), resolved ones as-is,
        unresolved ones predicted from weight presence."""
        out = {}
        for lang, path in self.paths.items():
            if lang in self._real:
                out[lang] = self._real[lang][0]
            else:
                out[lang] = "torch" if weights_present(path) else "noise"
        return out

    def _resolve(self, language: str):
        if language in self._real:
            return self._real[language]
        path = self.paths.get(language, "")
        if not weights_present(path):
            if not self.allow_noise:
                raise FileNotFoundError(
                    f"no local BERT weights for {language} at {path!r} and "
                    "allow_noise_bert=False; run `python -m "
                    "bert_vits2_tpu.tools.fetch_assets --fetch` to download "
                    "them (docs/WEIGHTS.md)"
                )
            warnings.warn(
                f"NO BERT WEIGHTS for language {language} (looked in "
                f"{path!r}) — synthesizing with SEEDED-NOISE prosody "
                "features. Output quality will be degraded; fetch real "
                "weights with `python -m bert_vits2_tpu.tools.fetch_assets "
                "--fetch` (docs/WEIGHTS.md), or silence this by passing an "
                "explicit bert_extractor.",
                stacklevel=3,
            )
            self._real[language] = ("noise", None)
            return self._real[language]
        if self._shared is None:
            from bert_vits2_tpu_torch.text.bert_encoder import BertEncoderExtractor

            self._shared = BertEncoderExtractor(paths=self.paths, device=self.device)
        self._shared._load(language)  # surface load errors here
        self._real[language] = ("torch", self._shared)
        logger.info("BERT extractor for %s: torch on %s (%s)", language,
                    self._shared.device, path)
        return self._real[language]

    def __call__(self, norm_text, word2ph, language, style_text=None,
                 style_weight: float = 0.7):
        _backend, ext = self._resolve(language)
        if ext is None:
            return self._noise(norm_text, word2ph, language,
                               style_text=style_text,
                               style_weight=style_weight)
        return ext(norm_text, word2ph, language, style_text=style_text,
                   style_weight=style_weight)
