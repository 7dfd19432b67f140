"""Japanese text frontend (behavioral reference: text/japanese.py:313-719).

Pipeline: NFKC normalize + number reading -> (pyopenjtalk when installed)
kanji reading + pitch-accent extraction -> kana -> julius-style phonemes
(ん->N, っ->q, long vowels expanded to repeated vowels) -> tones in {0,1}
from accent rise/fall events.

Without pyopenjtalk (no MeCab in this image) the kana path still works:
kana/romaji text is converted directly with flat (0) accents; kanji characters
raise a clear error pointing at the optional dependency.
"""

from __future__ import annotations

import re
import unicodedata

from bert_vits2_tpu_torch.text.symbols import PUNCTUATION

# ------------------------------------------------------------- kana mapping

def _build_kana_map() -> dict[str, str]:
    m: dict[str, str] = {}
    rows = [
        ("あいうえお", ""),
        ("かきくけこ", "k"), ("がぎぐげご", "g"),
        ("さしすせそ", "s"), ("ざじずぜぞ", "z"),
        ("たちつてと", "t"), ("だぢづでど", "d"),
        ("なにぬねの", "n"), ("はひふへほ", "h"),
        ("ばびぶべぼ", "b"), ("ぱぴぷぺぽ", "p"),
        ("まみむめも", "m"), ("らりるれろ", "r"),
    ]
    vowels = "aiueo"
    for kana_row, cons in rows:
        for kana, v in zip(kana_row, vowels):
            m[kana] = f" {cons} {v}" if cons else f" {v}"
    # irregular readings
    m.update({
        "し": " sh i", "じ": " j i", "ち": " ch i", "ぢ": " j i",
        "つ": " ts u", "づ": " z u", "ふ": " f u",
        "や": " y a", "ゆ": " y u", "よ": " y o",
        "わ": " w a", "ゐ": " i", "ゑ": " e", "を": " o",
        "ん": " N", "っ": " q", "ー": ":", "ゔ": " v u",
    })
    # palatalized digraphs
    digraph_cons = {
        "き": "ky", "ぎ": "gy", "し": "sh", "じ": "j", "ち": "ch", "ぢ": "j",
        "に": "ny", "ひ": "hy", "び": "by", "ぴ": "py", "み": "my", "り": "ry",
    }
    small = {"ゃ": "a", "ゅ": "u", "ょ": "o"}
    for kana, cons in digraph_cons.items():
        for sk, v in small.items():
            m[kana + sk] = f" {cons} {v}"
    # e-row + small: しぇ che etc.
    for kana, cons in {"し": "sh", "じ": "j", "ち": "ch"}.items():
        m[kana + "ぇ"] = f" {cons} e"
    # foreign-sound combinations
    m.update({
        "ふぁ": " f a", "ふぃ": " f i", "ふぇ": " f e", "ふぉ": " f o",
        "ふゅ": " hy u",
        "うぃ": " w i", "うぇ": " w e", "うぉ": " w o", "いぇ": " i e",
        "てぃ": " t i", "てゅ": " ty u", "でぃ": " d i", "でゅ": " dy u",
        "ずぃ": " z i",
        "つぁ": " ts a", "つぃ": " ts i", "つぇ": " ts e", "つぉ": " ts o",
        "ゔぁ": " v a", "ゔぃ": " v i", "ゔぇ": " v e", "ゔぉ": " v o",
        "ゔゅ": " by u",
        # bare small kana (compat: japanese.py:320)
        "ゃ": " y a", "ゅ": " y u", "ょ": " y o",
        "ぁ": " a", "ぃ": " i", "ぅ": " u", "ぇ": " e", "ぉ": " o",
    })
    return m


KANA_MAP = _build_kana_map()

_MARKS = re.compile(
    r"[^A-Za-z\d々぀-ヿ一-鿿１-９Ａ-Ｚ"
    r"ａ-ｚｦ-ﾝ]"
)

_PUNCT_REWRITE = {
    "：": ",", "；": ",", "，": ",", "。": ".", "！": "!", "？": "?",
    "\n": ".", "．": ".", "…": "...", "···": "...", "・・・": "...", "·": ",",
    "・": ",", "、": ",", "$": ".",
    "“": "'", "”": "'", '"': "'", "‘": "'", "’": "'",
    "（": "'", "）": "'", "(": "'", ")": "'",
    "《": "'", "》": "'", "【": "'", "】": "'", "[": "'", "]": "'",
    "—": "-", "−": "-", "～": "-", "~": "-", "「": "'", "」": "'",
}


def kata2hira(text: str) -> str:
    return "".join(
        chr(ord(c) - 0x60) if "ァ" <= c <= "ヶ" else c for c in text
    )


def hiragana_to_phones(txt: str) -> list[str]:
    """Hiragana -> phoneme list; long-vowel ':' expanded by repetition
    (japanese.py:313-348)."""
    out: list[str] = []
    i = 0
    while i < len(txt):
        for length in (3, 2, 1):
            chunk = txt[i : i + length]
            if chunk in KANA_MAP:
                out.append(KANA_MAP[chunk])
                i += length
                break
        else:
            i += 1  # unknown char: drop (the reference asserts instead)
    s = "".join(out).strip().replace(":+", ":")
    s = re.sub(r"(\w)(:*)", lambda m: m.group(1) + (" " + m.group(1)) * len(m.group(2)), s)
    s = s.replace("N", "n")  # ん reads as n in the final inventory
    return s.split()


def kata2phoneme(text: str) -> list[str]:
    """Katakana chunk -> phonemes, ー extends the previous vowel
    (japanese.py:350-370)."""
    text = text.strip()
    if text == "ー":
        return ["ー"]
    if text.startswith("ー"):
        return ["ー"] + kata2phoneme(text[1:])
    res: list[str] = []
    while text:
        if _MARKS.match(text):
            res.append(text[0])
            text = text[1:]
            continue
        res += hiragana_to_phones(kata2hira(text))
        break
    return res


def handle_long(sep_phonemes: list[list[str]]) -> list[list[str]]:
    for i in range(len(sep_phonemes)):
        if sep_phonemes[i] and sep_phonemes[i][0] == "ー":
            sep_phonemes[i][0] = sep_phonemes[i - 1][-1]
        if "ー" in sep_phonemes[i]:
            for j in range(len(sep_phonemes[i])):
                if sep_phonemes[i][j] == "ー":
                    sep_phonemes[i][j] = sep_phonemes[i][j - 1][-1]
    return sep_phonemes


# ------------------------------------------------------------ number reading

_DIGITS = ["", "いち", "に", "さん", "よん", "ご", "ろく", "なな", "はち", "きゅう"]
_SMALL_UNITS = ["", "じゅう", "ひゃく", "せん"]
_BIG_UNITS = ["", "まん", "おく", "ちょう"]
_SOUND_CHANGE = {
    "さんひゃく": "さんびゃく", "ろくひゃく": "ろっぴゃく", "はちひゃく": "はっぴゃく",
    "さんせん": "さんぜん", "はちせん": "はっせん", "いちちょう": "いっちょう",
}


def number_to_japanese(num: str) -> str:
    if "." in num:
        left, right = num.split(".", 1)
        return (
            number_to_japanese(left)
            + "てん"
            + "".join(_DIGITS[int(d)] if d != "0" else "ぜろ" for d in right)
        )
    n = int(num)
    if n == 0:
        return "ぜろ"
    parts = []
    group_idx = 0
    while n > 0:
        group = n % 10000
        if group:
            s = ""
            for pos in range(3, -1, -1):
                d = (group // 10**pos) % 10
                if d == 0:
                    continue
                word = ("" if d == 1 and pos > 0 else _DIGITS[d]) + _SMALL_UNITS[pos]
                for bad, good in _SOUND_CHANGE.items():
                    word = word.replace(bad, good)
                s += word
            parts.append(s + _BIG_UNITS[group_idx])
        n //= 10000
        group_idx += 1
    return "".join(reversed(parts))


def convert_numbers(text: str) -> str:
    text = re.sub(r"[0-9]{1,3}(,[0-9]{3})+", lambda m: m.group(0).replace(",", ""), text)
    cur = {"$": "ドル", "¥": "円", "£": "ポンド", "€": "ユーロ"}
    text = re.sub(
        r"([$¥£€])([0-9.]*[0-9])", lambda m: m.group(2) + cur.get(m.group(1), m.group(1)), text
    )
    try:
        from num2words import num2words

        return re.sub(
            r"[0-9]+(\.[0-9]+)?", lambda m: num2words(m.group(0), lang="ja"), text
        )
    except ImportError:
        # katakana (not hiragana) so the dictionary-fallback segmenter keeps
        # the number one segment and can apply counter readings (年->ネン)
        from bert_vits2_tpu_torch.text.ja_fallback import hira2kata

        return re.sub(
            r"[0-9]+(\.[0-9]+)?",
            lambda m: hira2kata(number_to_japanese(m.group(0))),
            text,
        )


def replace_punctuation(text: str) -> str:
    pat = re.compile("|".join(re.escape(p) for p in _PUNCT_REWRITE))
    text = pat.sub(lambda m: _PUNCT_REWRITE[m.group()], text)
    return re.sub(
        r"[^぀-ヿ一-鿿々" + "".join(PUNCTUATION) + r"]+",
        "",
        text,
    )


def text_normalize(text: str) -> str:
    res = unicodedata.normalize("NFKC", text)
    res = convert_numbers(res)
    res = replace_punctuation(res)
    return res.replace("゙", "")


# ------------------------------------------------------------------- accent

def _openjtalk():
    try:
        import pyopenjtalk

        return pyopenjtalk
    except ImportError:
        return None


def get_accent(parsed) -> list[tuple[str, int]]:
    """(phoneme, -1 fall / +1 rise / 0) events from HTS labels
    (japanese.py:415-440)."""
    pyopenjtalk = _openjtalk()
    labels = pyopenjtalk.make_label(parsed)
    phonemes, accents = [], []
    for n, label in enumerate(labels):
        phoneme = re.search(r"\-([^\+]*)\+", label).group(1)
        if phoneme in ("sil", "pau"):
            continue
        phonemes.append(phoneme.replace("cl", "q").lower())
        a1 = int(re.search(r"/A:(\-?[0-9]+)\+", label).group(1))
        a2 = int(re.search(r"\+(\d+)\+", label).group(1))
        nxt = re.search(r"\-([^\+]*)\+", labels[n + 1]).group(1)
        a2_next = -1 if nxt in ("sil", "pau") else int(
            re.search(r"\+(\d+)\+", labels[n + 1]).group(1)
        )
        if a1 == 0 and a2_next == a2 + 1:
            accents.append(-1)
        elif a2 == 1 and a2_next == 2:
            accents.append(1)
        else:
            accents.append(0)
    return list(zip(phonemes, accents))


def align_tones(phones: list[list[str]], tones: list[tuple[str, int]]) -> list[int]:
    """Turn rise/fall events into per-phone {0,1} tones (japanese.py:635-655)."""
    res = []
    tones = list(tones)
    for pho in phones:
        temp = [0] * len(pho)
        for idx, p in enumerate(pho):
            if not tones:
                break
            if p == tones[0][0]:
                temp[idx] = tones[0][1]
                if idx > 0:
                    temp[idx] += temp[idx - 1]
                tones.pop(0)
        temp = [0] + temp[:-1]
        if -1 in temp:
            temp = [i + 1 for i in temp]
        res.append(temp)
    flat = [t for sub in res for t in sub]
    assert all(0 <= t <= 1 for t in flat)
    return flat


# --------------------------------------------------------------------- g2p

_SYMBOL_TOKENS = set("・、。？！")
_NO_YOMI_TOKENS = set("「」『』―（）［］[]")

_KANA_ONLY = re.compile(r"^[぀-ヿー" + "".join(re.escape(p) for p in PUNCTUATION) + r"]*$")


def text2sep_kata(text: str):
    """Split into (words, readings, accent events) via openjtalk
    (japanese.py:376-413); kana-only fallback splits on punctuation."""
    pyopenjtalk = _openjtalk()
    if pyopenjtalk is None:
        if not _KANA_ONLY.match(text):
            raise RuntimeError(
                "Japanese g2p for kanji requires pyopenjtalk; install it or "
                "pass kana text."
            )
        parts = [p for p in re.split(r"([" + "".join(re.escape(x) for x in PUNCTUATION) + r"])", text) if p]
        return parts, parts, []
    parsed = pyopenjtalk.run_frontend(text)
    sep, res = [], []
    for parts in parsed:
        word = replace_punctuation(parts["string"])
        yomi = parts["pron"].replace("’", "")
        if yomi:
            if _MARKS.match(yomi):
                if len(word) > 1:
                    word = [replace_punctuation(i) for i in list(word)]
                    res += word
                    sep += word
                    continue
                elif word not in _PUNCT_REWRITE and word not in _PUNCT_REWRITE.values():
                    word = ","
                yomi = word
            res.append(yomi)
        else:
            if word in _SYMBOL_TOKENS:
                res.append(word)
            elif word in ("っ", "ッ"):
                res.append("ッ")
            elif word in _NO_YOMI_TOKENS:
                pass
            else:
                res.append(word)
        sep.append(word)
    return sep, res, get_accent(parsed)


def distribute_phone(n_phone: int, n_word: int) -> list[int]:
    per = [0] * n_word
    for _ in range(n_phone):
        per[per.index(min(per))] += 1
    return per


def _tokenize(word: str) -> list[str]:
    """Char-level tokenization (deberta-v2-japanese-char-wwm is char-level)."""
    return list(word) if word not in PUNCTUATION else [word]


def _g2p_fallback(norm_text: str):
    """pyopenjtalk-less g2p: lexicon segmentation + dictionary readings +
    accent-PHRASE pitch patterns (text/ja_fallback.py). Kanji degrade to
    dictionary lookup; particles/auxiliaries share their head word's pitch
    contour (the reference derives the same from full-context labels,
    japanese.py:405-430)."""
    from bert_vits2_tpu_torch.text import ja_fallback as jf

    phones: list[str] = []
    tones: list[int] = []
    word2ph: list[int] = []
    for phrase in jf.group_phrases(jf.segment(norm_text)):
        pitches = jf.phrase_pitches(phrase)
        off = 0
        for surface, reading, acc in phrase:
            if surface in PUNCTUATION:
                phones.append(surface)
                tones.append(0)
                word2ph.append(1)
                continue
            n_morae = len(jf.mora_split(reading))
            ph, tn = jf.word_phones_tones(
                reading, acc, kata2phoneme,
                pitches=pitches[off : off + n_morae],
            )
            off += n_morae
            ph = [
                p if p in _JA_PHONE_SET or p in PUNCTUATION else "UNK"
                for p in ph
            ]
            if not ph:
                # NO-DROP guarantee: a segment whose reading produced
                # nothing (unknown CJK char, unreadable symbol) still
                # renders as UNK — the reference's frontend never loses
                # input (japanese.py:677)
                ph, tn = ["UNK"], [0]
            phones += ph
            tones += tn
            word2ph += distribute_phone(len(ph), len(_tokenize(surface)))
    phones = ["_"] + phones + ["_"]
    tones = [0] + tones + [0]
    word2ph = [1] + word2ph + [1]
    assert len(phones) == len(tones)
    assert sum(word2ph) == len(phones)
    return phones, tones, word2ph


_JA_PHONE_SET = {
    "N", "a", "b", "by", "ch", "d", "dy", "e", "f", "g", "gy", "h", "hy",
    "i", "j", "k", "ky", "m", "my", "n", "ny", "o", "p", "py", "q", "r",
    "ry", "s", "sh", "t", "ts", "ty", "u", "v", "w", "y", "z", "zy",
}


def g2p(norm_text: str):
    if _openjtalk() is None:
        return _g2p_fallback(norm_text)
    sep_text, sep_kata, acc = text2sep_kata(norm_text)
    sep_tokenized = [_tokenize(w) for w in sep_text if w]
    sep_phonemes = handle_long([kata2phoneme(i) for i in sep_kata if i])

    tones = align_tones(sep_phonemes, acc) if acc else [
        0 for sub in sep_phonemes for _ in sub
    ]

    word2ph = []
    for token, phoneme in zip(sep_tokenized, sep_phonemes):
        word2ph += distribute_phone(len(phoneme), len(token))

    phones = ["_"] + [p for sub in sep_phonemes for p in sub] + ["_"]
    tones = [0] + tones + [0]
    word2ph = [1] + word2ph + [1]
    assert len(phones) == len(tones)
    return phones, tones, word2ph
