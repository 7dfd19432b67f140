"""English text frontend (behavioral reference: text/english.py:92-494).

g2p: CMUdict (syllabified `cmudict.rep`) lookup per word, ARPABET stress
digits mapped to tones (stress d -> tone d+1, consonants -> tone 3, matching
refine_ph at english.py:216-224), phones lower-cased ('v' -> 'V' ABI quirk).
Word grouping prefers the DeBERTa-v3 tokenizer (word2ph then aligns with the
BERT features); falls back to whitespace/punctuation splitting when the
tokenizer asset is missing. OOV words fall back to g2p_en when installed,
else a rule-based letter-to-sound.

CMUdict ships in `assets/` (a copy of the JAX package's bundled table);
BVT_CMUDICT or a `cmudict.rep` beside it in `assets/` takes precedence.
"""

from __future__ import annotations

import functools
import os
import re

from bert_vits2_tpu_torch.text.symbols import PUNCTUATION, SYMBOLS

_CMUDICT_CANDIDATES = [
    os.environ.get("BVT_CMUDICT", ""),
    os.path.join(os.path.dirname(__file__), "assets", "cmudict.rep"),
]
# bundled: the public-domain CMU Pronouncing Dictionary (syllabified), same
# 129482 entries the reference ships as text/cmudict.rep, re-encoded as
# "WORD|syl;syl" gz rows
_CMUDICT_BUNDLED = os.path.join(
    os.path.dirname(__file__), "assets", "cmudict.txt.gz"
)

_PUNCT_REWRITE = {
    "：": ",", "；": ",", "，": ",", "。": ".", "！": "!", "？": "?",
    "\n": ".", "·": ",", "、": ",", "…": "...", "···": "...", "・・・": "...",
    "“": "'", "”": "'", '"': "'", "‘": "'", "’": "'",
    "（": "'", "）": "'", "(": "'", ")": "'",
    "《": "'", "》": "'", "【": "'", "】": "'", "[": "'", "]": "'",
    "—": "-", "～": "-", "~": "-", "「": "'", "」": "'",
}


# ---------------------------------------------------------------- dictionary

@functools.lru_cache(maxsize=1)
def get_dict() -> dict:
    """Syllabified CMUdict: an override `.rep` file ('WORD  S1 P - S2 P' rows,
    48 header lines, reference english.py:173-194) when present, else the
    bundled gz asset — never empty."""
    path = next((p for p in _CMUDICT_CANDIDATES if p and os.path.exists(p)), None)
    out: dict[str, list[list[str]]] = {}
    if path is not None:
        with open(path, encoding="latin-1") as f:
            for i, line in enumerate(f):
                if i < 48:
                    continue
                line = line.strip()
                if not line or "  " not in line:
                    continue
                word, pron = line.split("  ", 1)
                out[word] = [syl.split(" ") for syl in pron.split(" - ")]
        return out
    import gzip

    with gzip.open(_CMUDICT_BUNDLED, "rt", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            word, pron = line.split("|", 1)
            out[word] = [syl.split(" ") for syl in pron.split(";")]
    return out


def refine_ph(phn: str) -> tuple[str, int]:
    """'AH0' -> ('ah', 1); consonants -> tone 3 (english.py:216-224)."""
    if phn and phn[-1].isdigit():
        return phn[:-1].lower(), int(phn[-1]) + 1
    return phn.lower(), 3


def post_replace_ph(ph: str) -> str:
    ph = _PUNCT_REWRITE.get(ph, ph)
    if ph == "v":
        ph = "V"
    return ph if ph in SYMBOLS else "UNK"


# -------------------------------------------------- rule-based LTS fallback
#
# Festival-style ordered rewrite rules: context-sensitive grapheme clusters
# checked longest-first at each position, plus magic-e long vowels, soft
# c/g, silent onsets/codas, -ed/-s voicing, and one-primary-stress
# normalization. Replaces g2p_en's neural fallback (reference
# text/english.py:421) with deterministic rules that give plausible
# syllable-bearing ARPABET for OOVs.

_VOWELS = set("aeiou")
_SIBILANT = {"S", "Z", "SH", "ZH", "CH", "JH"}
_VOICELESS = {"P", "T", "K", "F", "TH", "S", "SH", "CH", "HH"}

# suffix clusters (matched only at word end)
_LTS_SUFFIX = [
    ("tion", ["SH", "AH0", "N"]), ("ssion", ["SH", "AH0", "N"]),
    ("sion", ["ZH", "AH0", "N"]),
    ("cious", ["SH", "AH0", "S"]), ("tious", ["SH", "AH0", "S"]),
    ("cial", ["SH", "AH0", "L"]), ("tial", ["SH", "AH0", "L"]),
    ("ture", ["CH", "ER0"]), ("sure", ["ZH", "ER0"]),
    ("able", ["AH0", "B", "AH0", "L"]), ("ible", ["AH0", "B", "AH0", "L"]),
    ("ment", ["M", "AH0", "N", "T"]), ("ness", ["N", "AH0", "S"]),
    ("ful", ["F", "AH0", "L"]), ("ous", ["AH0", "S"]),
    ("ing", ["IH0", "NG"]), ("ship", ["SH", "IH0", "P"]),
    ("ley", ["L", "IY0"]), ("ly", ["L", "IY0"]), ("ey", ["IY0"]),
    ("air", ["EH1", "R"]), ("are", ["EH1", "R"]), ("ear", ["IH1", "R"]),
    ("eer", ["IH1", "R"]), ("ould", ["UH1", "D"]),
]

# general clusters (anywhere), longest-first within the scan
_LTS_DIGRAPHS = [
    ("eigh", ["EY1"]), ("tch", ["CH"]), ("dge", ["JH"]),
    ("igh", ["AY1"]), ("sch", ["S", "K"]), ("ght", ["T"]),
    ("ch", ["CH"]), ("sh", ["SH"]), ("th", ["TH"]), ("ph", ["F"]),
    ("wh", ["W"]), ("ck", ["K"]), ("ng", ["NG"]), ("qu", ["K", "W"]),
    ("ee", ["IY1"]), ("ea", ["IY1"]), ("ai", ["EY1"]),
    ("ay", ["EY1"]), ("oa", ["OW1"]), ("ou", ["AW1"]), ("ow", ["AW1"]),
    ("oy", ["OY1"]), ("oi", ["OY1"]), ("au", ["AO1"]), ("aw", ["AO1"]),
    ("ew", ["UW1"]), ("ue", ["UW1"]), ("ui", ["UW1"]), ("ei", ["IY1"]),
    ("eu", ["UW1"]), ("oe", ["OW1"]), ("oo", ["UW1"]), ("ss", ["S"]),
    ("ar", ["AA1", "R"]), ("or", ["AO1", "R"]), ("er", ["ER0"]),
    ("ir", ["ER1"]), ("ur", ["ER1"]),
]
_LTS_SINGLE = {
    "a": ["AE1"], "b": ["B"], "c": ["K"], "d": ["D"], "e": ["EH1"],
    "f": ["F"], "g": ["G"], "h": ["HH"], "i": ["IH1"], "j": ["JH"],
    "k": ["K"], "l": ["L"], "m": ["M"], "n": ["N"], "o": ["AA1"],
    "p": ["P"], "q": ["K"], "r": ["R"], "s": ["S"], "t": ["T"],
    "u": ["AH1"], "v": ["V"], "w": ["W"], "x": ["K", "S"], "y": ["Y"],
    "z": ["Z"],
}
_MAGIC_E = {"a": "EY1", "e": "IY1", "i": "AY1", "o": "OW1", "u": "UW1",
            "y": "AY1"}


def _magic_e(word: str, i: int) -> bool:
    """vowel + single consonant + final e (optionally +s/+d): long vowel."""
    rest = word[i + 1:]
    for tail in ("e", "es", "ed"):
        if rest.endswith(tail):
            mid = rest[: len(rest) - len(tail)]
            if len(mid) == 1 and mid not in _VOWELS and mid != "r":
                return True
    return False


def letter_to_sound(word: str) -> list[str]:
    """Rule-based LTS for OOVs when g2p_en is unavailable."""
    word = word.lower()
    word = "".join(c for c in word if c.isalpha())
    if not word:
        return []
    # silent onsets / codas
    for onset, repl in (("kn", "n"), ("gn", "n"), ("wr", "r"), ("ps", "s"),
                        ("pn", "n"), ("mn", "n")):
        if word.startswith(onset):
            word = repl + word[len(onset):]
    if word.endswith("mb"):
        word = word[:-1]
    # collapse doubled consonants up front (suffix rules then see the
    # canonical spelling); ss is kept — it carries the -ssion/-ss quality
    word = re.sub(r"([bcdfghjklmnpqrtvz])\1", r"\1", word)
    out: list[str] = []
    i = 0
    n = len(word)
    while i < n:
        c = word[i]
        rest = word[i:]
        # word-final voicing-sensitive endings
        if rest in ("ed",) and out:
            if out[-1] in ("T", "D"):
                out += ["IH0", "D"]
            elif out[-1] in _VOICELESS:
                out.append("T")
            else:
                out.append("D")
            break
        if rest in ("es",) and out:
            if out[-1] in _SIBILANT:
                out += ["IH0", "Z"]
            elif out[-1] in _VOICELESS:
                out.append("S")
            else:
                out.append("Z")
            break
        if rest == "s" and out:
            out.append("S" if out[-1] in _VOICELESS else "Z")
            break
        if rest == "e" and out and len(word) > 2:
            break  # final silent e
        if rest == "y" and out:
            out.append("IY0")
            break
        if rest == "a" and out:
            out.append("AH0")  # final unstressed a: schwa
            break
        if rest == "le" and out and out[-1] not in (
                "AE1", "EH1", "IH1", "AA1", "AH1"):
            out += ["AH0", "L"]
            break
        matched = False
        for pat, phones in _LTS_SUFFIX:
            if rest == pat or (rest == pat + "s"):
                out += phones
                if rest.endswith("s") and rest != pat:
                    out.append("Z" if phones[-1] not in _VOICELESS else "S")
                i = n
                matched = True
                break
        if matched:
            break
        # magic e
        if c in _MAGIC_E and _magic_e(word, i):
            out.append(_MAGIC_E[c])
            i += 1
            continue
        for pat, phones in _LTS_DIGRAPHS:
            if rest.startswith(pat):
                # oo before k: book/look vowel
                if pat == "oo" and word[i + 2: i + 3] == "k":
                    out.append("UH1")
                else:
                    out += phones
                i += len(pat)
                matched = True
                break
        if matched:
            continue
        nxt = word[i + 1: i + 2]
        if c == "c":
            out.append("S" if nxt in ("e", "i", "y") else "K")
        elif c == "g" and nxt in ("e", "i", "y"):
            out.append("JH")
        elif c == "s" and out and i + 1 < n and word[i - 1] in _VOWELS \
                and nxt in _VOWELS:
            out.append("Z")  # intervocalic s
        elif c == "y" and out:
            out.append("IH1")  # consonant-final y mid-word (gym)
        elif c == "x" and not out:
            out.append("Z")  # xylo-
        else:
            out += _LTS_SINGLE.get(c, [])
        # collapse doubled consonants
        if i + 1 < n and word[i + 1] == c and c not in _VOWELS:
            i += 1
        i += 1
    # exactly one primary stress: keep the first "1" vowel, demote the rest
    seen_primary = False
    for k, p in enumerate(out):
        if p.endswith("1"):
            if seen_primary:
                out[k] = p[:-1] + "0"
            seen_primary = True
    if not seen_primary:
        for k, p in enumerate(out):
            if p.endswith("0"):
                out[k] = p[:-1] + "1"
                break
    return out


def _oov_phones(word: str) -> list[str]:
    try:
        from g2p_en import G2p

        g = _cached_g2p()
        return [p for p in g(word) if p != " "]
    except ImportError:
        return letter_to_sound(word)


@functools.lru_cache(maxsize=1)
def _cached_g2p():
    from g2p_en import G2p

    return G2p()


# ------------------------------------------------------------- word grouping

@functools.lru_cache(maxsize=1)
def _deberta_tokenizer():
    path = os.environ.get("BVT_EN_BERT", "./bert/deberta-v3-large")
    try:
        from transformers import DebertaV2Tokenizer

        return DebertaV2Tokenizer.from_pretrained(path)
    except Exception:
        return None


def text_to_words(text: str) -> list[list[str]]:
    """Group sub-tokens into words (english.py:394-418); tokenizer-free
    fallback: each whitespace/punct-split chunk is one single-piece word."""
    tok = _deberta_tokenizer()
    if tok is None:
        chunks = [w for w in re.split(r"([,;.\?\!\s+'])", text) if w.strip()]
        return [[c] for c in chunks]
    tokens = tok.tokenize(text)
    words: list[list[str]] = []
    for idx, t in enumerate(tokens):
        if t.startswith("▁"):
            words.append([t[1:]])
        elif t in PUNCTUATION:
            if idx == len(tokens) - 1:
                words.append([t])
            elif (
                not tokens[idx + 1].startswith("▁")
                and tokens[idx + 1] not in PUNCTUATION
            ):
                if idx == 0:
                    words.append([])
                words[-1].append(t)
            else:
                words.append([t])
        else:
            if idx == 0:
                words.append([])
            words[-1].append(t)
    return words


def distribute_phone(n_phone: int, n_word: int) -> list[int]:
    """Spread phones across sub-tokens as evenly as possible (english.py:385-391)."""
    per = [0] * n_word
    for _ in range(n_phone):
        per[per.index(min(per))] += 1
    return per


# ----------------------------------------------------------------- numbers

_ONES = ["", "one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
         "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen", "sixteen",
         "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALE = [(10**9, "billion"), (10**6, "million"), (10**3, "thousand"), (100, "hundred")]
_ORD_IRREG = {"one": "first", "two": "second", "three": "third", "five": "fifth",
              "eight": "eighth", "nine": "ninth", "twelve": "twelfth"}


def number_to_words(n: int) -> str:
    if n == 0:
        return "zero"
    if n < 0:
        return "minus " + number_to_words(-n)
    parts = []
    for scale, name in _SCALE:
        if n >= scale:
            parts.append(number_to_words(n // scale) + " " + name)
            n %= scale
    if n >= 20:
        word = _TENS[n // 10]
        if n % 10:
            word += " " + _ONES[n % 10]
        parts.append(word)
    elif n > 0:
        parts.append(_ONES[n])
    return " ".join(parts)


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ")
    if last in _ORD_IRREG:
        last = _ORD_IRREG[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    return (head + " " + last).strip()


def normalize_numbers(text: str) -> str:
    """Commas, currency, decimals, ordinals, years (english.py:193-249)."""
    text = re.sub(r"([0-9][0-9\,]+[0-9])", lambda m: m.group(1).replace(",", ""), text)
    text = re.sub(r"£([0-9\,]*[0-9]+)", r"\1 pounds", text)

    def dollars(m):
        parts = m.group(1).split(".")
        d = int(parts[0]) if parts[0] else 0
        c = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        if d and c:
            return f"{d} dollar{'s' if d != 1 else ''}, {c} cent{'s' if c != 1 else ''}"
        if d:
            return f"{d} dollar{'s' if d != 1 else ''}"
        if c:
            return f"{c} cent{'s' if c != 1 else ''}"
        return "zero dollars"

    text = re.sub(r"\$([0-9\.\,]*[0-9]+)", dollars, text)
    text = re.sub(r"([0-9]+\.[0-9]+)", lambda m: m.group(1).replace(".", " point "), text)
    text = re.sub(r"[0-9]+(st|nd|rd|th)", lambda m: ordinal_to_words(int(m.group(0)[:-2])), text)

    def plain(m):
        num = int(m.group(0))
        if 1000 < num < 3000:
            if num == 2000:
                return "two thousand"
            if 2000 < num < 2010:
                return "two thousand " + number_to_words(num % 100)
            if num % 100 == 0:
                return number_to_words(num // 100) + " hundred"
            return (
                number_to_words(num // 100) + " " + (
                    "oh " + _ONES[num % 100] if num % 100 < 10 else number_to_words(num % 100)
                )
            )
        return number_to_words(num)

    return re.sub(r"[0-9]+", plain, text)


_ABBREV = [
    (re.compile(rf"\b{a}\.", re.IGNORECASE), b)
    for a, b in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
        ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
        ("drs", "doctors"),
    ]
]


def replace_punctuation(text: str) -> str:
    for pat, rep in _ABBREV:
        text = pat.sub(rep, text)
    pat = re.compile("|".join(re.escape(p) for p in _PUNCT_REWRITE))
    return pat.sub(lambda m: _PUNCT_REWRITE[m.group()], text)


def text_normalize(text: str) -> str:
    text = normalize_numbers(text)
    text = replace_punctuation(text)
    return re.sub(r"([,;.\?\!])([\w])", r"\1 \2", text)


# ------------------------------------------------------------------- g2p

def g2p(text: str):
    eng_dict = get_dict()
    phones: list[str] = []
    tones: list[int] = []
    phone_len: list[int] = []
    words = text_to_words(text)

    for word in words:
        temp_phones: list[str] = []
        temp_tones: list[int] = []
        if len(word) > 1 and "'" in word:
            word = ["".join(word)]
        for w in word:
            if w in PUNCTUATION:
                temp_phones.append(w)
                temp_tones.append(0)
                continue
            if w.upper() in eng_dict:
                for syl in eng_dict[w.upper()]:
                    for ph in syl:
                        p, t = refine_ph(ph)
                        temp_phones.append(post_replace_ph(p))
                        temp_tones.append(t)
            else:
                for ph in _oov_phones(w):
                    if ph and (ph[-1].isdigit() or ph.isalpha()):
                        p, t = refine_ph(ph)
                        temp_phones.append(post_replace_ph(p))
                        temp_tones.append(t)
                    else:
                        temp_phones.append(post_replace_ph(ph))
                        temp_tones.append(0)
        phones += temp_phones
        tones += temp_tones
        phone_len.append(len(temp_phones))

    word2ph: list[int] = []
    for token, pl in zip(words, phone_len):
        word2ph += distribute_phone(pl, len(token))

    phones = ["_"] + phones + ["_"]
    tones = [0] + tones + [0]
    word2ph = [1] + word2ph + [1]
    assert len(phones) == len(tones), text
    assert len(phones) == sum(word2ph), text
    return phones, tones, word2ph
