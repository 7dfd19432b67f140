"""Version routing for config.json files (reference: infer.py:39-104,
oldVersion/).

Counterpart of `bert_vits2_tpu/compat/versions.py`, field for field (a
test pins the two together). Every version family is one configuration of
the same `Synthesizer`:

| family | symbols | tones | BERT inputs             | emotion conditioning       |
|--------|---------|-------|-------------------------|----------------------------|
| 1.0.x  | 108     | 11    | bert                    | —                          |
| 1.1.x  | 112     | 11    | bert, ja_bert(768)      | —                          |
| 2.0.x  | 112     | 12    | bert, ja_bert, en_bert  | —                          |
| 2.1    | 112     | 12    | bert, ja_bert, en_bert  | wav2vec2 1024-d + VQ(10)   |
| 2.2    | 112     | 12    | bert, ja_bert, en_bert  | CLAP 512-d + VQ(64x32heads)|
| 2.3    | 112     | 12    | bert, ja_bert, en_bert  | —                          |

(oldVersion/V101/models.py:342, V110/models.py:343, V200/models.py:341-342,
V210/models.py:347-356, V220/models.py:380-402.)

Symbol tables: 1.1+ is the current 112-symbol inventory; 1.0.x predates the
julius long-vowel romanization (its Japanese set has I/U/cl instead of
a:/e:/i:/o:/u:/ty/zy, oldVersion/V101/text/symbols.py), so its 108-entry
table is derived from the current one by that substitution.

Inactive-language BERT fill: 2.3 feeds N(0,1) noise (infer.py:126-137),
every earlier version zeros (oldVersion/V200/__init__.py:29-37). An unknown
version string means the latest family.
"""

from __future__ import annotations

import dataclasses

from bert_vits2_tpu_torch.text.symbols import (
    LANGUAGE_ID_MAP,
    NUM_ZH_TONES,
    PU_SYMBOLS,
    SYMBOLS,
)

LATEST_VERSION = "2.3"

# oldVersion/V101/text/symbols.py vs text/symbols.py set difference
_V101_JA_REMOVED = {"a:", "e:", "i:", "o:", "u:", "ty", "zy"}
_V101_JA_ADDED = {"I", "U", "cl"}

_NORMAL = [s for s in SYMBOLS[1:] if s not in PU_SYMBOLS]
V101_SYMBOLS = (
    [SYMBOLS[0]]
    + sorted((set(_NORMAL) - _V101_JA_REMOVED) | _V101_JA_ADDED)
    + PU_SYMBOLS
)


@dataclasses.dataclass(frozen=True)
class VersionSpec:
    family: str
    symbols: tuple
    num_tones: int
    tone_start: dict  # language -> tone offset
    languages: tuple  # languages this version can synthesize
    use_ja_bert: bool = True
    use_en_bert: bool = True
    ja_bert_dim: int = 1024
    emotion: str = "none"  # ModelConfig.emotion
    emo_dim: int = 0  # emotion feature width fed to infer
    inactive_fill: str = "zeros"  # "zeros" | "randn"

    @property
    def n_vocab(self) -> int:
        return len(self.symbols)

    @property
    def symbol_to_id(self) -> dict:
        return {s: i for i, s in enumerate(self.symbols)}

    def model_overrides(self) -> dict:
        """ModelConfig kwargs that this version family pins."""
        return dict(
            n_vocab=self.n_vocab,
            num_tones=self.num_tones,
            use_ja_bert=self.use_ja_bert,
            use_en_bert=self.use_en_bert,
            ja_bert_dim=self.ja_bert_dim,
            emotion=self.emotion,
        )

    def cleaned_text_to_sequence(self, cleaned_text, tones, language):
        """Per-version phone/tone/language ids (the reference routes to
        oldVersion/Vxxx/text/__init__.py). Phones missing from an old table
        map to UNK."""
        s2i = self.symbol_to_id
        unk = s2i["UNK"]
        phones = [s2i.get(s, unk) for s in cleaned_text]
        start = self.tone_start[language]
        return (
            phones,
            [t + start for t in tones],
            [LANGUAGE_ID_MAP[language]] * len(phones),
        )


_SYMBOLS_NOW = tuple(SYMBOLS)
_TONES_V1 = {"ZH": 0, "JP": NUM_ZH_TONES, "EN": NUM_ZH_TONES + 1}
_TONES_V2 = {"ZH": 0, "JP": NUM_ZH_TONES, "EN": NUM_ZH_TONES + 2}
_V2 = dict(symbols=_SYMBOLS_NOW, num_tones=12, tone_start=_TONES_V2,
           languages=("ZH", "JP", "EN"))

_FAMILIES = {
    "1.0": VersionSpec(
        family="1.0", symbols=tuple(V101_SYMBOLS), num_tones=NUM_ZH_TONES + 1 + 4,
        tone_start=_TONES_V1, languages=("ZH",), use_ja_bert=False,
        use_en_bert=False),
    "1.1": VersionSpec(
        family="1.1", symbols=_SYMBOLS_NOW, num_tones=NUM_ZH_TONES + 1 + 4,
        tone_start=_TONES_V1, languages=("ZH", "JP"), use_en_bert=False,
        ja_bert_dim=768),
    "2.0": VersionSpec(family="2.0", **_V2),
    "2.1": VersionSpec(family="2.1", emotion="vq210", emo_dim=1024, **_V2),
    "2.2": VersionSpec(family="2.2", emotion="clap220", emo_dim=512, **_V2),
    "2.3": VersionSpec(family="2.3", inactive_fill="randn", **_V2),
}

# config.json `version` strings -> family (reference infer.py:42-70)
VERSION_TO_FAMILY = {
    "1.0": "1.0", "1.0.0": "1.0", "1.0.1": "1.0",
    "1.1": "1.1", "1.1.0": "1.1", "1.1.1": "1.1", "1.1.1-fix": "1.1",
    "2.0": "2.0", "2.0.1": "2.0", "2.0.2-fix": "2.0",
    "2.1": "2.1",
    "2.2": "2.2",
    "2.3": "2.3",
}


def family_for(version: str | None) -> str:
    """config.json version string -> family name (unknown -> latest)."""
    v = str(version or LATEST_VERSION)
    fam = VERSION_TO_FAMILY.get(v) or VERSION_TO_FAMILY.get(".".join(v.split(".")[:2]))
    return fam or LATEST_VERSION


def spec_for(version: str | None) -> VersionSpec:
    """config.json version string -> VersionSpec (unknown -> latest)."""
    return _FAMILIES[family_for(version)]


__all__ = ["VersionSpec", "spec_for", "family_for", "LATEST_VERSION",
           "V101_SYMBOLS", "VERSION_TO_FAMILY"]
