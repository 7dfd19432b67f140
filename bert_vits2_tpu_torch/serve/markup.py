"""Mix-mode speaker/language markup (reference: re_matching.py:4-47).

Grammar: `[speaker]<lang>text<lang>text ... [speaker2]<lang>text ...`
parse_mix_text -> [(speaker, [(lang, text), ...]), ...].
"""

from __future__ import annotations

import re

_SPEAKER_BLOCK = re.compile(r"(\[\S+?\])(.+?)(?=\[\S+?\]|$)", re.DOTALL)
_LANG_TEXT = re.compile(r"<(\S+?)>([^<]+)", re.DOTALL)
_VALID_BLOCK = re.compile(r"(\[\S+?\])((?:\s*<\S+?>[^<\[\]]+?)+)", re.DOTALL)


def parse_mix_text(text: str) -> list[tuple[str, list[tuple[str, str]]]]:
    """-> [(speaker, [(LANG, segment), ...]), ...]; langs uppercased,
    segments stripped (re_matching.text_matching behavior)."""
    out = []
    for speaker_tag, dialogue in _SPEAKER_BLOCK.findall(text):
        segs = [
            (lang.upper(), seg.strip())
            for lang, seg in _LANG_TEXT.findall(dialogue)
            if seg.strip()
        ]
        if segs:
            out.append((speaker_tag[1:-1], segs))
    return out


def validate_mix_text(text: str) -> tuple[bool, str]:
    """Mirror of re_matching.validate_text's checks + messages."""
    matches = _VALID_BLOCK.findall(text)
    if not matches:
        return (
            False,
            "Error: No valid speaker format detected. Please check your input.",
        )
    for _speaker, dialogue in matches:
        if not _LANG_TEXT.findall(dialogue):
            return (
                False,
                "Error: Invalid format detected in dialogue content. "
                "Please check your input.",
            )
    return True, "Input is valid."
