"""Version routing for config.json files (reference: infer.py:39-104).

Counterpart of `bert_vits2_tpu/compat/versions.py`, cut to what the port
synthesizes: the V2.3 family. The alias table `VERSION_TO_FAMILY` and the
rule that an unknown version means the latest are copies of the JAX
module's (a test pins them); a version of any other family (1.0-2.2: other
symbol tables, zero inactive-language fills, emotion inputs) raises until
those families are ported (ROADMAP §A.6).
"""

from __future__ import annotations

import dataclasses

LATEST_VERSION = "2.3"

# config.json `version` strings -> family (reference infer.py:42-70)
VERSION_TO_FAMILY = {
    "1.0": "1.0", "1.0.0": "1.0", "1.0.1": "1.0",
    "1.1": "1.1", "1.1.0": "1.1", "1.1.1": "1.1", "1.1.1-fix": "1.1",
    "2.0": "2.0", "2.0.1": "2.0", "2.0.2-fix": "2.0",
    "2.1": "2.1",
    "2.2": "2.2",
    "2.3": "2.3",
}


@dataclasses.dataclass(frozen=True)
class VersionSpec:
    """What a version family pins; only the V2.3 family exists in the port:
    112 symbols, 12 tones, three 1024-d BERT inputs, no emotion input (and
    N(0,1) features for the inactive languages, infer.py:126-137)."""

    family: str = "2.3"
    n_vocab: int = 112
    num_tones: int = 12
    ja_bert_dim: int = 1024
    emotion: str = "none"

    def model_overrides(self) -> dict:
        """ModelConfig kwargs that this version family pins."""
        return dict(n_vocab=self.n_vocab, num_tones=self.num_tones,
                    use_ja_bert=True, use_en_bert=True,
                    ja_bert_dim=self.ja_bert_dim, emotion=self.emotion)


def family_for(version: str | None) -> str:
    """config.json version string -> family name (unknown -> latest)."""
    v = str(version or LATEST_VERSION)
    fam = VERSION_TO_FAMILY.get(v) or VERSION_TO_FAMILY.get(".".join(v.split(".")[:2]))
    return fam or LATEST_VERSION


def spec_for(version: str | None) -> VersionSpec:
    """config.json version string -> VersionSpec; only the 2.3 family."""
    fam = family_for(version)
    if fam != "2.3":
        raise NotImplementedError(
            f"version {version!r} is of the {fam} family; the port synthesizes "
            "the 2.3 family only (old-version families: ROADMAP §A.6)")
    return VersionSpec()


__all__ = ["VersionSpec", "spec_for", "family_for", "LATEST_VERSION",
           "VERSION_TO_FAMILY"]
