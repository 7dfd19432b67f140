"""Language identification + sentence segmentation for auto/mixed-language
serving (reference behavior: tools/classify_language.py:115-173,
tools/sentence.py:17-151).

The reference shells out to langid/fastlid; neither ships here, so
`classify_language` is a Unicode-script vote over the candidate languages —
deterministic, dependency-free, and restricted to the model's languages
(which is what serving passes as target_languages anyway).
"""

from __future__ import annotations

import re

# Punctuation class used by the reference to pre-split before language ID
# (tools/sentence.py:18-23). 　-range CJK punct + ASCII punct.
_SPLIT_PUNCT = (
    r"[\!\"\#\$\%\&\'\(\)\*\+\,\-\.\/\:\;\<\>\=\?\@\[\]\{\}\\\^\_\`"
    r"！？。＂＃＄％＆＇（）"
    r"＊＋，－／：；＜＝＞＠"
    r"［＼］＾＿｀｛｜｝～｟"
    r"｠｢｣､、〃》「」『』"
    r"【】〔〕〖〗〘〙〚〛〜"
    r"〝〞〟〰〾〿–—‘’‛"
    r"“”„‟…‧﹏·]+"
)

_HIRAGANA = (0x3040, 0x309F)
_KATAKANA = (0x30A0, 0x30FF)
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0xF900, 0xFAFF))
_KANA_EXT = ((0x31F0, 0x31FF), (0xFF66, 0xFF9D))


def _char_lang(ch: str) -> str | None:
    cp = ord(ch)
    if _HIRAGANA[0] <= cp <= _HIRAGANA[1] or _KATAKANA[0] <= cp <= _KATAKANA[1]:
        return "ja"
    for lo, hi in _KANA_EXT:
        if lo <= cp <= hi:
            return "ja"
    for lo, hi in _CJK:
        if lo <= cp <= hi:
            return "zh"  # han: zh unless kana present (resolved at text level)
    if ("a" <= ch <= "z") or ("A" <= ch <= "Z"):
        return "en"
    return None


def classify_language(text: str, target_languages: list | None = None) -> str:
    """'zh' | 'ja' | 'en' (lowercase, like langid's labels).

    Script vote: any kana -> ja; else han -> zh (or ja if zh isn't a target);
    else latin -> en. Ties/unknowns fall back to the first target or 'zh'.
    """
    targets = [t.lower() for t in (target_languages or ["zh", "ja", "en"])]
    votes = {"zh": 0, "ja": 0, "en": 0}
    has_kana = False
    for ch in text:
        lang = _char_lang(ch)
        if lang:
            votes[lang] += 1
            if lang == "ja":
                has_kana = True
    if has_kana and "ja" in targets:
        return "ja"
    if votes["zh"]:
        if "zh" in targets:
            return "zh"
        if "ja" in targets:  # kanji-only text for a JA-only model
            return "ja"
    if votes["en"] and "en" in targets:
        return "en"
    for lang in ("zh", "ja", "en"):
        if votes[lang] and lang in targets:
            return lang
    return targets[0] if targets else "zh"


def split_alpha_nonalpha(text: str) -> list[str]:
    """Split latin runs from CJK runs (tools/classify_language.py
    split_alpha_nonalpha) so 'vits和Bert' -> ['vits', '和', 'Bert']."""
    out = re.split(
        r"(?<=[一-鿿぀-ヿ\d\s])(?=[a-zA-Z])"
        r"|(?<=[a-zA-Z\s])(?=[一-鿿぀-ヿ\d])",
        text,
    )
    return [s for s in out if s]


def split_by_language(
    text: str, target_languages: list | None = None
) -> list[tuple[str, str]]:
    """[(segment, lang), ...] covering `text` exactly, language-contiguous.

    Ref: tools/sentence.py:59-96. Splits on punctuation (and latin/CJK
    boundaries when en is among the targets), classifies each piece, and
    merges adjacent same-language spans keeping original punctuation.
    """
    sentences = re.split(_SPLIT_PUNCT, text)
    targets = [t.lower() for t in (target_languages or ["zh", "ja", "en"])]
    if "en" in targets:
        expanded = []
        for s in sentences:
            expanded.extend(split_alpha_nonalpha(s))
        sentences = expanded

    pre_lang, start, end = "", 0, 0
    out: list[tuple[str, str]] = []
    for sentence in sentences:
        if not sentence or sentence.isspace():
            continue
        lang = classify_language(sentence, targets)
        end += text[end:].index(sentence)
        if pre_lang and pre_lang != lang:
            out.append((text[start:end], pre_lang))
            start = end
        end += len(sentence)
        pre_lang = lang
    out.append((text[start:], pre_lang or (targets[0] if targets else "zh")))
    return out


def markup_language(text: str, target_languages: list | None = None) -> str:
    """Annotate language switches as `[ZH]...[EN]...` markup
    (tools/sentence.py:17-56 behavior, built on split_by_language)."""
    segs = split_by_language(text, target_languages)
    return "".join(f"[{lang.upper()}]{seg}" for seg, lang in segs) + (
        f"[{segs[-1][1].upper()}]" if segs else ""
    )


def sentence_split(text: str, max_len: int) -> list[str]:
    """Greedy split into chunks of >= max_len chars at punctuation boundaries
    (tools/sentence.py:99-120)."""
    pattern = r"[!(),—+\-.:;?？。，、；：]+"
    pieces = re.split(pattern, text)
    seps = re.findall(pattern, text)
    out, count, p = [], 0, 0
    for i, sep in enumerate(seps):
        count += len(pieces[i]) + len(sep)
        if count >= max_len:
            out.append(text[p : p + count].strip())
            p += count
            count = 0
    if p < len(text):
        out.append(text[p:])
    return [s for s in out if s and not s.isspace()]


def cut_paragraphs(text: str) -> list[str]:
    """Split on newlines, dropping blanks (re_matching.py cut_para)."""
    return [p.strip() for p in text.split("\n") if p.strip()]


def cut_sentences(para: str) -> list[str]:
    """Chinese-aware sentence cutter (re_matching.py cut_sent)."""
    para = re.sub(r"([。！;？?])([^”’])", r"\1\n\2", para)
    para = re.sub(r"(\.{6})([^”’])", r"\1\n\2", para)
    para = re.sub(r"(…{2})([^”’])", r"\1\n\2", para)
    para = re.sub(
        r"([。！？?][”’])([^，。！？?])",
        r"\1\n\2",
        para,
    )
    return [s for s in para.rstrip().split("\n") if s]
