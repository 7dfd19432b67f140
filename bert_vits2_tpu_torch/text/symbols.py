"""Symbol inventory — the checkpoint ABI (reference: text/symbols.py:1-182).

A copy of `bert_vits2_tpu/text/symbols.py`, so that the port never imports
the JAX package; a test pins the two together.

The 112-entry symbol list, 12 tones and 3 language ids must match the
reference exactly or imported checkpoints mis-index their embedding tables.
The list is: pad "_" + sorted(zh | ja | en phone sets) + punctuation + SP/UNK.
"""

from __future__ import annotations

PUNCTUATION = ["!", "?", "…", ",", ".", "'", "-"]
PU_SYMBOLS = PUNCTUATION + ["SP", "UNK"]
PAD = "_"

# Mandarin phones: initials + opencpop-strict finals (incl. apical i0/ir and
# zero-initial markers AA/EE/OO, see mandarin.py pinyin_to_phones)
ZH_INITIALS = [
    "b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h",
    "j", "q", "x", "zh", "ch", "sh", "r", "z", "c", "s", "y", "w",
]
ZH_FINALS = [
    "E", "En", "a", "ai", "an", "ang", "ao", "e", "ei", "en", "eng", "er",
    "i", "i0", "ia", "ian", "iang", "iao", "ie", "in", "ing", "iong", "ir",
    "iu", "o", "ong", "ou", "u", "ua", "uai", "uan", "uang", "ui", "un",
    "uo", "v", "van", "ve", "vn",
]
ZH_SYMBOLS = sorted(set(ZH_INITIALS + ZH_FINALS + ["AA", "EE", "OO"]))
NUM_ZH_TONES = 6

# Japanese phones (julius-style romanization; q = sokuon, N = moraic n,
# ':' marks long vowels)
JA_CONSONANTS = [
    "N", "b", "by", "ch", "d", "dy", "f", "g", "gy", "h", "hy", "j", "k",
    "ky", "m", "my", "n", "ny", "p", "py", "q", "r", "ry", "s", "sh", "t",
    "ts", "ty", "w", "y", "z", "zy",
]
JA_VOWELS = ["a", "a:", "e", "e:", "i", "i:", "o", "o:", "u", "u:"]
JA_SYMBOLS = sorted(set(JA_CONSONANTS + JA_VOWELS))
NUM_JA_TONES = 2

# English phones (lower-case ARPABET, stress stripped into tones; "V" is the
# reference's quirk for AH0-as-schwa distinction kept for ABI compat)
EN_SYMBOLS = [
    "aa", "ae", "ah", "ao", "aw", "ay", "b", "ch", "d", "dh", "eh", "er",
    "ey", "f", "g", "hh", "ih", "iy", "jh", "k", "l", "m", "n", "ng", "ow",
    "oy", "p", "r", "s", "sh", "t", "th", "uh", "uw", "V", "w", "y", "z",
    "zh",
]
NUM_EN_TONES = 4

NORMAL_SYMBOLS = sorted(set(ZH_SYMBOLS + JA_SYMBOLS + EN_SYMBOLS))
SYMBOLS = [PAD] + NORMAL_SYMBOLS + PU_SYMBOLS
SIL_PHONEME_IDS = [SYMBOLS.index(s) for s in PU_SYMBOLS]

NUM_TONES = NUM_ZH_TONES + NUM_JA_TONES + NUM_EN_TONES

LANGUAGE_ID_MAP = {"ZH": 0, "JP": 1, "EN": 2}
NUM_LANGUAGES = len(LANGUAGE_ID_MAP)
LANGUAGE_TONE_START_MAP = {
    "ZH": 0,
    "JP": NUM_ZH_TONES,
    "EN": NUM_ZH_TONES + NUM_JA_TONES,
}

SYMBOL_TO_ID = {s: i for i, s in enumerate(SYMBOLS)}

# lowercase aliases matching the reference's public names
symbols = SYMBOLS
punctuation = PUNCTUATION
num_tones = NUM_TONES
num_languages = NUM_LANGUAGES
language_id_map = LANGUAGE_ID_MAP
language_tone_start_map = LANGUAGE_TONE_START_MAP
