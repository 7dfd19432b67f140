"""Dictionary-based Japanese reading + pitch-accent fallback.

The reference derives kanji readings and Tokyo pitch accents from
pyopenjtalk's NAIST dictionary + HTS labels (reference text/japanese.py:
376-440). pyopenjtalk/MeCab are optional here; when absent this module makes
kanji text *degrade to dictionary lookup* instead of raising, and gives kana
non-flat accents:

- a hand-curated lexicon (``assets/ja_lexicon.tsv``) of common words:
  surface -> katakana reading + NHK-style accent type (0 = heiban,
  1 = atamadaka, k = drop after mora k),
- a COMPLETE per-character kanji reading table (``assets/ja_kanji.tsv``,
  all joyo + common hyogai chars; on'yomi for compound degradation, with
  optional kun stems applied before okurigana) so out-of-lexicon
  compounds degrade to per-character readings instead of dropped text,
- longest-match segmentation, particle heuristics (は->ワ, へ->エ, を->オ),
- accent-type -> per-mora H/L -> per-phoneme {0,1} tones (the same tone
  inventory align_tones produces from HTS labels, japanese.py:635-655),
- a NO-DROP guarantee: every CJK character in the input yields at least
  one phone (an ``UNK`` placeholder in the worst case) — the reference's
  pyopenjtalk frontend never loses input (japanese.py:677 run_frontend).

This is a *degraded* mode: readings of rare compounds and accent sandhi
across phrases won't match NAIST output. With pyopenjtalk installed the
primary path is used instead and this module is never imported.
"""

from __future__ import annotations

import functools
import os

_ASSET = os.path.join(os.path.dirname(__file__), "assets", "ja_lexicon.tsv")
_KANJI_ASSET = os.path.join(os.path.dirname(__file__), "assets", "ja_kanji.tsv")

_SMALL = "ャュョァィゥェォヮ"
_HIRA2KATA = {chr(h): chr(h + 0x60) for h in range(0x3041, 0x3097)}


def hira2kata(text: str) -> str:
    return "".join(_HIRA2KATA.get(c, c) for c in text)


@functools.lru_cache(maxsize=1)
def lexicon() -> dict[str, tuple[str, int]]:
    """surface -> (katakana reading, accent type)."""
    out: dict[str, tuple[str, int]] = {}
    with open(_ASSET, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            surface, reading, acc = line.split("\t")
            out[surface] = (reading, int(acc))
            hira = "".join(
                chr(ord(c) - 0x60) if "ァ" <= c <= "ヶ" else c for c in surface
            )
            if hira != surface and hira not in out:
                out[hira] = (reading, int(acc))
    # derived i-adjective conjugations (寒い -> 寒かった/寒くない/...).
    # Tokyo rule: an accented adjective keeps its kernel clamped to the
    # stem (samuꜜkatta); a heiban one stays heiban in the past and gains
    # the ない kernel (akakunaꜜi) in the negative.
    derived = {}
    for w, (r, a) in out.items():
        if not (w.endswith("い") and r.endswith("イ") and len(w) > 1):
            continue
        stem_w, stem_r = w[:-1], r[:-1]
        sm = len(mora_split(stem_r))
        k = min(a, sm) if a > 0 else 0
        for suf, rsuf, kk in (
            ("かった", "カッタ", k),
            ("くて", "クテ", k),
            ("くない", "クナイ", k if a > 0 else sm + 2),
            ("くなかった", "クナカッタ", k if a > 0 else sm + 2),
        ):
            key = stem_w + suf
            if key not in out:
                derived[key] = (stem_r + rsuf, kk)
    out.update(derived)
    return out


@functools.lru_cache(maxsize=1)
def kanji_table() -> dict[str, tuple[str, str | None]]:
    """Single character -> (dominant reading, optional kun stem).

    Layering: the full ja_kanji.tsv table (all joyo + common hyogai) is the
    base; the hand-curated ``#KANJI`` rows in ja_lexicon.tsv override its
    dominant reading (they pick standalone-usage readings). The kun stem,
    when present, is used before okurigana (書 followed by く reads カ,
    giving カク) instead of the compound on'yomi."""
    out: dict[str, tuple[str, str | None]] = {}
    with open(_KANJI_ASSET, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            kun = parts[2] if len(parts) > 2 and parts[2] else None
            out[parts[0]] = (parts[1], kun)
    with open(_ASSET, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line.startswith("#KANJI\t"):
                continue
            _, char, reading = line.split("\t")
            out[char] = (reading, out.get(char, (None, None))[1])
    return out


def kanji_readings() -> dict[str, str]:
    """Single character -> dominant katakana reading (OOV degradation)."""
    return {c: on for c, (on, _kun) in kanji_table().items()}


@functools.lru_cache(maxsize=1)
def _max_word_len() -> int:
    return max((len(k) for k in lexicon()), default=1)


_PARTICLES = {"は": "ワ", "へ": "エ", "を": "オ"}

# counter readings used when the char follows a number (数詞+助数詞);
# standalone these kanji read via the lexicon/kanji table instead
_COUNTERS = {
    "年": "ネン", "月": "ガツ", "日": "ニチ", "時": "ジ", "分": "フン",
    "秒": "ビョー", "人": "ニン", "円": "エン", "回": "カイ", "個": "コ",
    "本": "ホン", "冊": "サツ", "歳": "サイ", "台": "ダイ", "匹": "ヒキ",
    "枚": "マイ", "番": "バン", "階": "カイ", "度": "ド", "点": "テン",
}
# morae that occur in Japanese number readings (ゼロ/イチ/ニ/サン/ヨン/ゴ/
# ロク/ナナ/ハチ/キュー/ジュー/ヒャク/セン/マン/オク/チョー/テン)
_NUMBER_KANA = set("ゼロレイチニサンヨシゴクナハキュウジッヒャビピセマオチョテンーュ")


def _is_number_reading(kata: str) -> bool:
    return bool(kata) and all(c in _NUMBER_KANA for c in kata)


def _is_cjk(c: str) -> bool:
    return "一" <= c <= "鿿" or c == "々" or "㐀" <= c <= "䶿" or "豈" <= c <= "﫿" or ord(c) >= 0x20000


def segment(text: str) -> list[tuple[str, str, int]]:
    """Longest-match -> [(surface, katakana reading, accent type)].

    Kana runs not in the lexicon read as themselves (kana is phonetic);
    OOV kanji fall back to per-character readings (kun stem before
    okurigana, on'yomi otherwise); a CJK char absent even from the full
    kanji table gets an empty reading, which the g2p layer renders as an
    UNK phone — input is NEVER dropped. Anything else passes through one
    char at a time (punctuation is handled by the caller)."""
    lex = lexicon()
    ktab = kanji_table()
    out: list[tuple[str, str, int]] = []
    i, n = 0, len(text)
    max_len = _max_word_len()
    while i < n:
        c = text[i]
        # counter after a number: 年->ネン, 日->ニチ, ...
        if c in _COUNTERS and out and _is_number_reading(out[-1][1]):
            out.append((c, _COUNTERS[c], 0))
            i += 1
            continue
        # 々 repeats the previous character's reading
        if c == "々" and out:
            out.append((c, out[-1][1], 0))
            i += 1
            continue
        matched = False
        for length in range(min(max_len, n - i), 0, -1):
            cand = text[i : i + length]
            if cand in lex:
                reading, acc = lex[cand]
                # particle heuristic: a bare は/へ after another segment is
                # (almost always) the particle — reading ワ/エ
                if length == 1 and cand in ("は", "へ") and out:
                    reading = _PARTICLES[cand]
                    acc = 0
                out.append((cand, reading, acc))
                i += length
                matched = True
                break
        if matched:
            continue
        if c == "を":
            out.append((c, "オ", 0))
            i += 1
        elif "ぁ" <= c <= "ゖ" or "ァ" <= c <= "ヶ" or c in "ーッっ":
            # unknown kana run: group the maximal kana stretch, read as-is
            j = i
            while j < n and ("ぁ" <= text[j] <= "ゖ" or "ァ" <= text[j] <= "ヶ"
                             or text[j] in "ーッっ"):
                if text[i:j + 1] in lex and j > i:
                    break
                j += 1
            run = text[i:j]
            for piece in _split_aux_suffixes(run):
                if piece in lex:
                    out.append((piece, *lex[piece]))
                else:
                    out.append((piece, hira2kata(piece), 0))
            i = j
        elif c in ktab:
            on, kun = ktab[c]
            nxt = text[i + 1] if i + 1 < n else ""
            if kun and "ぁ" <= nxt <= "ゖ":
                # kun stem + okurigana merge into ONE word segment
                # (書きます -> 書き; the phrase layer then hangs ます off
                # it) so the accent contour spans the whole verb
                j = i + 1
                while j < n and ("ぁ" <= text[j] <= "ゖ" or text[j] == "っ"):
                    j += 1
                oku = _okurigana(text[i + 1 : j])
                surface = c + oku
                if surface in lex:
                    out.append((surface, *lex[surface]))
                else:
                    out.append((surface, kun + hira2kata(oku), 0))
                i += 1 + len(oku)
            else:
                out.append((c, on, 0))
                i += 1
        elif _is_cjk(c):
            # unknown CJK char: empty reading -> UNK phone downstream
            out.append((c, "", 0))
            i += 1
        else:
            out.append((c, c, 0))
            i += 1
    return out


# -------------------------------------------------------- accent phrases

# particles attach to the preceding content word's accent phrase and
# continue its pitch (水が = LH+H, not LH+L); they never add a kernel
PARTICLES = {
    "は", "が", "を", "に", "で", "と", "も", "の", "へ", "や", "か", "ね",
    "よ", "な", "わ", "さ", "ぞ", "ぜ", "ば", "し", "って", "たり",
    "から", "まで", "より", "だけ", "ほど", "など", "くらい", "ぐらい",
    "しか", "でも", "こそ",
    # て-form connector: prosodically continues the verb's phrase
    # (買っ+て+ください is ONE accent phrase)
    "て",
}
# copula-family auxiliaries: contribute their own kernel ONLY after a
# heiban head (学生で'す) — an accented head keeps its kernel (高'いです)
AUX_COPULA = {"です", "でした", "でしょう", "だ", "だった", "だろう"}
# polite/desiderative/negative verb endings OVERRIDE the stem's kernel
# (食べません = タベマセ'ン regardless of 食べ's accent)
AUX_OVERRIDE = {
    "ます", "ました", "ません", "ましょう", "まして",
    "たい", "たかった", "ない", "なかった",
    "ています", "でいます", "ていました", "でいました",
    "ていません", "でいません", "ている", "でいる", "ていた", "でいた",
    "ないで",
}
# する-verb forms: attach to a preceding verbal noun (勉強します is ONE
# accent phrase) but, like the copula, only fill a kernel when the phrase
# is still heiban (料理します keeps リョ'ーリ)
SURU_FORMS = {
    "する", "します", "しました", "しません", "しましょう", "して",
    "した", "しない", "しなかった", "しよう",
}
# て-form continuatives: attach only after a て/で reading (して+います,
# 行って+ください)
TE_CONT = {"います", "いました", "いません", "いる", "いた", "いない",
           "ください"}

_ATTACH = PARTICLES | AUX_COPULA | AUX_OVERRIDE
_AUX_FILL = AUX_COPULA | SURU_FORMS | TE_CONT


_AUX_SUFFIXES = tuple(sorted((
    "ましょう", "でしょう", "なかった", "たかった", "ました", "ません",
    "まして", "でした", "ます", "です", "たい", "ない",
    "ていました", "でいました", "ていません", "でいません",
    "ています", "でいます", "ていた", "でいた", "ている", "でいる",
    "ください", "ないで",
), key=len, reverse=True))


def _split_aux_suffixes(run: str, min_rest: int = 1) -> list[str]:
    """Split verb-ending auxiliaries off an unknown kana run so the accent
    layer can apply their kernels: かない -> [か, ない], きませんでした ->
    [き, ません, でした]. With the default min_rest=1 the remainder must
    stay non-empty (ない alone is the adjective 無い, not an ending);
    okurigana splitting passes 0 (見ています -> 見 + ています)."""
    pieces: list[str] = []
    while True:
        for suf in _AUX_SUFFIXES:
            if run.endswith(suf) and len(run) >= len(suf) + min_rest:
                pieces.append(suf)
                run = run[: -len(suf)]
                break
        else:
            break
    pieces.append(run)
    return list(reversed(pieces))


# particles that end an okurigana run (they belong to the NEXT phrase
# grouping step, not to the verb/adjective itself)
_OKU_PARTICLES = set("のがはをにへともかねよなわさ")


def _okurigana(s: str) -> str:
    """The okurigana part of a kana run following a kun-read kanji: strip
    auxiliary endings (ます/ない/...) and trailing particles — those become
    their own segments. May be empty (見ています: the kanji IS the stem)."""
    s = _split_aux_suffixes(s, min_rest=0)[0]
    while len(s) > 1 and s[-1] in _OKU_PARTICLES:
        s = s[:-1]
    return s


def _is_boundary(seg: tuple[str, str, int]) -> bool:
    """Punctuation / unreadable segments break accent phrases."""
    surface, reading, _ = seg
    if not reading:
        return True
    c = surface[0]
    return not (
        _is_cjk(c) or "ぁ" <= c <= "ゖ" or "ァ" <= c <= "ヶ" or c in "ーッ"
    )


def group_phrases(
    segs: list[tuple[str, str, int]],
) -> list[list[tuple[str, str, int]]]:
    """Group segments into accent phrases: a content word plus its attached
    particles/auxiliaries share ONE pitch contour (the reference gets this
    from full-context label A-fields, japanese.py:405-430). Punctuation and
    unreadable segments are singleton boundary phrases."""
    phrases: list[list[tuple[str, str, int]]] = []
    for seg in segs:
        prev = phrases[-1][-1] if phrases else None
        joinable = (
            phrases and not _is_boundary(seg) and not _is_boundary(prev)
        )
        attach = joinable and (
            seg[0] in _ATTACH
            or (seg[0] in SURU_FORMS and prev[0] not in PARTICLES)
            or (seg[0] in TE_CONT and prev[1][-1:] in ("テ", "デ"))
        )
        if attach:
            phrases[-1].append(seg)
        else:
            phrases.append([seg])
    return phrases


def phrase_pitches(phrase: list[tuple[str, str, int]]) -> list[int]:
    """Per-mora H(1)/L(0) over a whole accent phrase.

    Kernel resolution: the head keeps its lexical accent; AUX_OVERRIDE
    endings replace it at their own offset; AUX_COPULA supplies one only
    when the phrase is still heiban; particles never do."""
    total = sum(len(mora_split(r)) for _, r, _ in phrase)
    kernel = 0
    offset = 0
    for idx, (surface, reading, acc) in enumerate(phrase):
        n = len(mora_split(reading))
        if idx == 0:
            if acc > 0:
                kernel = min(acc, n)
        elif surface in AUX_OVERRIDE and acc > 0:
            kernel = offset + min(acc, n)
        elif kernel == 0 and surface in _AUX_FILL and acc > 0:
            kernel = offset + min(acc, n)
        offset += n
    return accent_pitches(total, kernel)


# -------------------------------------------------------------- accent maths

def mora_split(kata: str) -> list[str]:
    """Katakana -> morae (small kana attach left; ー/ッ/ン count as morae)."""
    morae: list[str] = []
    for c in kata:
        if c in _SMALL and morae:
            morae[-1] += c
        else:
            morae.append(c)
    return morae


def accent_pitches(n_morae: int, acc: int) -> list[int]:
    """Tokyo pitch pattern: per-mora H(1)/L(0) for accent type `acc`."""
    if n_morae == 0:
        return []
    if acc == 1:
        return [1] + [0] * (n_morae - 1)
    if acc == 0:
        return [0] + [1] * (n_morae - 1)
    k = min(acc, n_morae)
    return [0] + [1] * (k - 1) + [0] * (n_morae - k)


def word_phones_tones(
    reading: str, acc: int, kata2phoneme, pitches: list[int] | None = None
) -> tuple[list[str], list[int]]:
    """Reading + accent -> (phonemes, per-phoneme {0,1} tones).

    Phonemes per mora come from the caller's kata2phoneme so the inventory
    matches the primary path exactly; the word-level concatenation equals
    kata2phoneme(reading) (ー expansion spans morae via the running last
    vowel). `pitches` overrides the word-local accent pattern with a slice
    of an accent-phrase contour (group_phrases/phrase_pitches)."""
    morae = mora_split(reading)
    if pitches is None:
        pitches = accent_pitches(len(morae), acc)
    phones: list[str] = []
    tones: list[int] = []
    last_vowel = "e"  # ー with no preceding vowel: rare, arbitrary but stable
    for mora, pitch in zip(morae, pitches):
        if mora == "ー":
            ph = [last_vowel]
        else:
            ph = kata2phoneme(mora)
        for p in ph:
            phones.append(p)
            tones.append(pitch)
            if p and p[-1] in "aiueo":
                last_vowel = p[-1]
            elif p == "n" or p == "N":
                last_vowel = p
    return phones, tones


__all__ = [
    "lexicon", "kanji_table", "kanji_readings", "segment", "mora_split",
    "accent_pitches", "word_phones_tones", "hira2kata",
]
