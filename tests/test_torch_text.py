"""PyTorch port, text frontend: the port's copy of the g2p modules and their
assets against the JAX package's originals (both JAX-free; no JAX here).

- each asset file equal to its original by sha256;
- each copied module's source equal to the original with the imports
  renamed (english.py: also without the home-directory dictionary path);
- `clean_text` exactly equal (norm_text, phones, tones, word2ph) and
  `cleaned_text_to_sequence` exactly equal, on every sentence of
  tests/goldens/*.json and every literal sentence that tests/test_text.py
  cleans, in ZH, JP and EN.
"""

import ast
import hashlib
import json
from pathlib import Path

import pytest

from bert_vits2_tpu import text as jax_text
from bert_vits2_tpu_torch import text as port_text

REPO = Path(__file__).resolve().parent.parent
JAX_TEXT = REPO / "bert_vits2_tpu" / "text"
PORT_TEXT = REPO / "bert_vits2_tpu_torch" / "text"
ASSETS = sorted(p.name for p in (JAX_TEXT / "assets").iterdir())
COPIED = ("mandarin_lexicon", "ja_fallback", "mandarin_sandhi", "mandarin",
          "japanese", "english", "cleaner")


def test_assets_are_the_six_originals():
    assert len(ASSETS) == 6
    assert sorted(p.name for p in (PORT_TEXT / "assets").iterdir()) == ASSETS


@pytest.mark.parametrize("name", ASSETS)
def test_asset_sha256(name):
    digest = lambda p: hashlib.sha256(p.read_bytes()).hexdigest()  # noqa: E731
    assert digest(PORT_TEXT / "assets" / name) == digest(JAX_TEXT / "assets" / name)


@pytest.mark.parametrize("module", COPIED)
def test_module_source_is_the_original(module):
    want = (JAX_TEXT / f"{module}.py").read_text().replace(
        "bert_vits2_tpu.text", "bert_vits2_tpu_torch.text")
    if module == "english":
        want = want.replace(
            "CMUdict is an external asset (like the reference's bundled copy): set\n"
            "BVT_CMUDICT or drop cmudict.rep into ~/.cache/bert_vits2_tpu/.\n",
            "CMUdict ships in `assets/` (a copy of the JAX package's bundled table);\n"
            "BVT_CMUDICT or a `cmudict.rep` beside it in `assets/` takes precedence.\n",
        ).replace('    os.path.expanduser("~/.cache/bert_vits2_tpu/cmudict.rep"),\n', "")
    assert (PORT_TEXT / f"{module}.py").read_text() == want


def _test_text_sentences():
    """(text, language) of every clean_text call in tests/test_text.py whose
    text is a literal, or a literal of the list its loop walks."""
    tree = ast.parse((REPO / "tests" / "test_text.py").read_text())
    lists = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.List):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    lists[tgt.id] = node.value
    out = []
    for loop in [n for n in ast.walk(tree) if isinstance(n, ast.For)]:
        it = loop.iter
        if isinstance(it, ast.Attribute) and it.attr in lists:
            it = lists[it.attr]
        if not isinstance(it, ast.List):
            continue
        for call in ast.walk(loop):
            if (isinstance(call, ast.Call) and getattr(call.func, "id", "") == "clean_text"
                    and isinstance(call.args[1], ast.Constant)):
                for elt in it.elts:
                    first = elt.elts[0] if isinstance(elt, ast.Tuple) else elt
                    out.append((first.value, call.args[1].value))
    for call in ast.walk(tree):
        if (isinstance(call, ast.Call) and getattr(call.func, "id", "") == "clean_text"
                and all(isinstance(a, ast.Constant) for a in call.args)):
            out.append((call.args[0].value, call.args[1].value))
    return list(dict.fromkeys(out))


def _golden_sentences():
    out = [(row["text"], "EN") for row in json.loads(
        (REPO / "tests" / "goldens" / "en_ref_goldens.json").read_text())]
    self_goldens = json.loads(
        (REPO / "tests" / "goldens" / "zh_ja_self_goldens.json").read_text())
    for lang in ("ZH", "JP"):
        out += [(row["text"], lang) for row in self_goldens[lang]]
    return out


SENTENCES = {"goldens": _golden_sentences(), "test_text": _test_text_sentences()}


def test_sentence_sets_cover_three_languages():
    for source, rows in SENTENCES.items():
        assert {lang for _, lang in rows} == {"ZH", "JP", "EN"}, source
    assert len(SENTENCES["goldens"]) == 140
    assert len(SENTENCES["test_text"]) >= 30


@pytest.mark.parametrize("source", sorted(SENTENCES))
@pytest.mark.parametrize("lang", ["ZH", "JP", "EN"])
def test_clean_text_and_sequence_match_jax(source, lang):
    rows = [t for t, la in SENTENCES[source] if la == lang]
    assert rows
    for text in rows:
        want = jax_text.clean_text(text, lang)
        got = port_text.clean_text(text, lang)
        assert got[0] == want[0], text
        for g, w in zip(got[1:], want[1:]):
            assert list(g) == list(w), text
        assert (port_text.cleaned_text_to_sequence(got[1], got[2], lang)
                == jax_text.cleaned_text_to_sequence(want[1], want[2], lang)), text
