"""Mandarin text frontend: normalization, segmentation, g2p, tone sandhi.

Behavioral reference: text/chinese.py:79-184 (+ opencpop-strict.txt). The
pinyin->phoneme mapping there is a 429-entry table; it is fully systematic, so
here it is an algorithm: initial/final split plus the apical-vowel (i0/ir),
ü (v) and zero-initial (AA/EE/OO, y-rewrites) rules.

hanzi->pinyin comes from a pluggable backend: pypinyin when installed
(matching the reference), else the embedded frequency lexicon in
`mandarin_lexicon.py` (common characters + polyphonic words).
"""

from __future__ import annotations

import re

from bert_vits2_tpu_torch.text.symbols import PUNCTUATION

_INITIALS = [
    "zh", "ch", "sh", "b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h",
    "j", "q", "x", "r", "z", "c", "s", "y", "w",
]

# zero-initial syllables get a glottal-ish marker phone (opencpop-strict rows
# a->AA a, e->EE e, o->OO o, ...)
_ZERO_INITIAL_MARK = {"a": "AA", "e": "EE", "o": "OO"}

# full-width / CJK punctuation rewrite (text/chinese.py:31-60)
_PUNCT_REWRITE = {
    "：": ",", "；": ",", "，": ",", "。": ".", "！": "!", "？": "?",
    "\n": ".", "·": ",", "、": ",", "...": "…", "$": ".",
    "“": "'", "”": "'", '"': "'", "‘": "'", "’": "'",
    "（": "'", "）": "'", "(": "'", ")": "'",
    "《": "'", "》": "'", "【": "'", "】": "'", "[": "'", "]": "'",
    "—": "-", "～": "-", "~": "-", "「": "'", "」": "'",
}


def split_pinyin(syllable: str) -> tuple[str, str]:
    """'zhong' -> ('zh', 'ong'); zero-initial returns ('', final)."""
    for ini in _INITIALS:
        if syllable.startswith(ini):
            return ini, syllable[len(ini):]
    return "", syllable


def pinyin_to_phones(pinyin: str) -> list[str]:
    """Toneless pinyin syllable (already y/w-normalized) -> phoneme pair.

    Implements the opencpop-strict mapping algorithmically:
    - zh/ch/sh/r + i -> ir ; z/c/s + i -> i0   (apical vowels)
    - j/q/x/y + u/uan/ue/un -> v/van/ve/vn     (ü spelled u)
    - y + an -> En ; y + e -> E
    - zero-initial a*/e*/o* -> AA/EE/OO + final
    """
    ini, fin = split_pinyin(pinyin)
    if not ini:
        mark = _ZERO_INITIAL_MARK.get(fin[0])
        if mark is None:
            raise ValueError(f"unparseable pinyin syllable: {pinyin!r}")
        return [mark, fin]
    if fin == "i" and ini in ("zh", "ch", "sh", "r"):
        fin = "ir"
    elif fin == "i" and ini in ("z", "c", "s"):
        fin = "i0"
    elif ini in ("j", "q", "x", "y") and fin in ("u", "uan", "ue", "un"):
        fin = {"u": "v", "uan": "van", "ue": "ve", "un": "vn"}[fin]
    if ini == "y":
        if fin == "an":
            fin = "En"
        elif fin == "e":
            fin = "E"
    return [ini, fin]


def normalize_zero_initial(pinyin: str) -> str:
    """Rewrite bare-final syllables the way Mandarin orthography does.

    (text/chinese.py:141-160: ing->ying, i->yi, in->yin, u->wu, then
    v->yu / i->y / u->w prefix rewrites.)
    """
    ini, _ = split_pinyin(pinyin)
    if ini:
        return pinyin
    whole = {"ing": "ying", "i": "yi", "in": "yin", "u": "wu"}
    if pinyin in whole:
        return whole[pinyin]
    head = {"v": "yu", "i": "y", "u": "w"}
    if pinyin[0] in head:
        return head[pinyin[0]] + pinyin[1:]
    return pinyin


# contracted spellings restored before phone lookup (chinese.py:131-139)
_CONTRACTED = {"uei": "ui", "iou": "iu", "uen": "un"}


def syllable_to_phones(initial: str, final_with_tone: str) -> tuple[list[str], int]:
    """(pypinyin-style initial, final+tone digit) -> (phones, tone)."""
    tone = int(final_with_tone[-1])
    fin = final_with_tone[:-1]
    if initial:
        fin = _CONTRACTED.get(fin, fin)
        pinyin = initial + fin
    else:
        pinyin = normalize_zero_initial(fin)
    return pinyin_to_phones(pinyin), tone


def replace_punctuation(text: str) -> str:
    """Normalize punctuation and strip non-hanzi. Ref: chinese.py:63-74."""
    text = text.replace("嗯", "恩").replace("呣", "母")
    pat = re.compile("|".join(re.escape(p) for p in _PUNCT_REWRITE))
    text = pat.sub(lambda m: _PUNCT_REWRITE[m.group()], text)
    text = re.sub(r"[^一-龥" + "".join(PUNCTUATION) + r"]+", "", text)
    return text


def _segment(text: str):
    """jieba POS segmentation (jieba is a hard dep; it is pure Python)."""
    import jieba.posseg as psg

    return psg.lcut(text)


def _word_pinyin(word: str) -> list[str]:
    """Per-character toneless-final+tone3-style pinyin list for `word`.

    Uses pypinyin when available (reference behavior, chinese.py:96-106),
    else the embedded lexicon.
    """
    try:
        from pypinyin import Style, lazy_pinyin

        finals = lazy_pinyin(word, neutral_tone_with_five=True, style=Style.FINALS_TONE3)
        initials = lazy_pinyin(word, neutral_tone_with_five=True, style=Style.INITIALS)
        return list(zip(initials, finals))
    except ImportError:
        from bert_vits2_tpu_torch.text.mandarin_lexicon import word_to_pinyin

        out = []
        for ch, syl in zip(word, word_to_pinyin(word)):
            if syl is None:
                # unknown char / punctuation: initial==final==char marks it
                # for the punctuation branch downstream (chinese.py:121-127)
                out.append((ch, ch))
                continue
            ini, fin = split_pinyin(syl[:-1])
            out.append((ini, fin + syl[-1]))
        return out


def word_finals(word: str) -> list[str]:
    """FINALS_TONE3-style finals for sandhi decisions."""
    return [f for _, f in _word_pinyin(word)]


def _merge_polyphone_words(seg_cut):
    """Re-join adjacent tokens whose concatenation is a curated polyphone
    word (jieba splits e.g. 还钱 -> 还/钱, which would read hai2; the merged
    token hits WORD_PINYIN / pypinyin's phrase dict and reads huan2)."""
    from bert_vits2_tpu_torch.text.mandarin_lexicon import WORD_PINYIN

    out, i = [], 0
    while i < len(seg_cut):
        if i + 1 < len(seg_cut):
            joined = seg_cut[i][0] + seg_cut[i + 1][0]
            if joined in WORD_PINYIN:
                out.append((joined, seg_cut[i][1]))
                i += 2
                continue
        out.append(tuple(seg_cut[i]))
        i += 1
    return out


def _g2p_segments(sentences: list[str]):
    from bert_vits2_tpu_torch.text.mandarin_sandhi import ToneSandhi

    sandhi = ToneSandhi(word_finals)
    phones_list, tones_list, word2ph = [], [], []
    for seg in sentences:
        seg = re.sub("[a-zA-Z]+", "", seg)
        seg_cut = _merge_polyphone_words(sandhi.pre_merge(_segment(seg)))
        initials, finals = [], []
        for word, pos in seg_cut:
            if pos == "eng":
                continue
            pairs = _word_pinyin(word)
            sub_initials = [i for i, _ in pairs]
            sub_finals = sandhi.modified_tone(word, pos, [f for _, f in pairs])
            initials += sub_initials
            finals += sub_finals
        for c, v in zip(initials, finals):
            if c == v:
                # punctuation token (initial==final==char); hanzi missing
                # from the fallback lexicon become UNK so word2ph stays
                # aligned with the normalized text (reference post-replace
                # maps out-of-symbol phones to UNK, chinese.py:70-76)
                phones_list.append(c if c in PUNCTUATION else "UNK")
                tones_list.append(0)
                word2ph.append(1)
                continue
            phone, tone = syllable_to_phones(c, v)
            phones_list += phone
            tones_list += [tone] * len(phone)
            word2ph.append(len(phone))
    return phones_list, tones_list, word2ph


def g2p(text: str):
    """Normalized text -> (phones, tones, word2ph), padded with '_' like the
    reference (chinese.py:79-90)."""
    pattern = r"(?<=[{0}])\s*".format("".join(PUNCTUATION))
    sentences = [s for s in re.split(pattern, text) if s.strip()]
    phones, tones, word2ph = _g2p_segments(sentences)
    assert sum(word2ph) == len(phones)
    phones = ["_"] + phones + ["_"]
    tones = [0] + tones + [0]
    word2ph = [1] + word2ph + [1]
    return phones, tones, word2ph


def _number_to_hanzi(num: str) -> str:
    """Minimal Arabic-numeral reader (replaces cn2an when unavailable)."""
    digits = "零一二三四五六七八九"
    units = ["", "十", "百", "千"]
    big_units = ["", "万", "亿"]
    if "." in num:
        left, right = num.split(".", 1)
        return (
            _number_to_hanzi(left) + "点" + "".join(digits[int(d)] for d in right if d.isdigit())
        )
    n = int(num)
    if n == 0:
        return "零"
    parts = []
    group_idx = 0
    while n > 0:
        group = n % 10000
        if group:
            s = ""
            zero_pending = False
            for pos in range(3, -1, -1):
                d = (group // 10**pos) % 10
                if d == 0:
                    if s:
                        zero_pending = True
                    continue
                if zero_pending:
                    s += "零"
                    zero_pending = False
                if not (d == 1 and pos == 1 and s == "" and group < 100):
                    s += digits[d]
                s += units[pos]
            parts.append(s + big_units[group_idx])
        elif parts:
            parts.append("零")
        n //= 10000
        group_idx += 1
    out = "".join(reversed(parts))
    return re.sub("零+", "零", out).strip("零") or "零"


def text_normalize(text: str) -> str:
    """TN + punctuation rewrite. Uses WeTextProcessing/cn2an when installed
    (reference behavior, chinese.py:9-18), else the built-in number reader."""
    normalizer = None
    try:
        from tn.chinese.normalizer import Normalizer

        normalizer = Normalizer(
            remove_interjections=False, remove_erhua=False, overwrite_cache=True
        ).normalize
    except ImportError:
        try:
            import cn2an

            normalizer = lambda x: cn2an.transform(x, "an2cn")  # noqa: E731
        except ImportError:
            normalizer = lambda x: re.sub(  # noqa: E731
                r"\d+(?:\.\d+)?", lambda m: _number_to_hanzi(m.group()), x
            )
    text = normalizer(text)
    return replace_punctuation(text)
