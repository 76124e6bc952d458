"""The text stack runs on the standard library alone: the splitter's
Unicode classes come from `unicodedata` (checked against the `regex`
module's \\p{..} classes where that module is installed), and a
missing `tokenizers` package falls back to another segmenter."""

import re
import sys
import unicodedata

import pytest

from slimt_jax.text import splitter

CLASSES = ["L", "Lo", "N", "Nd", "Nl", "M", "S", "Pf", "Ll", "Lu", "Lt"]

# U+0295 changed category (Ll -> Lo) after Python's Unicode 15.0
# database; the two engines disagree on it by design.
CHANGED_SINCE_PYTHON_DB = {0x295}


def _sample_code_points():
    """Every 7th code point of the BMP and SMP, plus the first and
    last code point of each category run (class boundaries)."""
    points = set(range(0, 0x20000, 7))
    for runs in splitter._category_ranges().values():
        for first, last in runs:
            if last < 0x20000:
                points.update((first, last))
    return sorted(points - CHANGED_SINCE_PYTHON_DB)


@pytest.mark.parametrize("cls", CLASSES)
def test_unicode_class_matches_regex(cls):
    regex = pytest.importorskip("regex")
    ours = re.compile(f"[{splitter.unicode_class(cls)}]")
    theirs = regex.compile(r"\p{%s}" % cls)
    unassigned = regex.compile(r"\p{Cn}")
    checked = 0
    for cp in _sample_code_points():
        ch = chr(cp)
        # Compare only where both Unicode databases assign the point.
        if unicodedata.category(ch) == "Cn" or unassigned.match(ch):
            continue
        checked += 1
        assert bool(ours.match(ch)) == bool(theirs.match(ch)), hex(cp)
    assert checked > 10000


def test_whitespace_class_matches_pcre_semantics():
    """_WS is PCRE2's \\s: str.isspace() minus U+001C-U+001F."""
    ws = re.compile(splitter._WS)
    for cp in range(0x3001):
        ch = chr(cp)
        want = ch.isspace() and not 0x1C <= cp <= 0x1F
        assert bool(ws.match(ch)) == want, hex(cp)


def test_whitespace_class_matches_regex():
    regex = pytest.importorskip("regex")
    ws = re.compile(splitter._WS)
    for cp in range(0x3001):
        ch = chr(cp)
        assert bool(ws.match(ch)) == bool(regex.match(r"\s", ch)), hex(cp)


def test_splitter_imports_no_regex_module():
    import importlib
    import subprocess

    code = (
        "import sys; sys.modules['regex'] = None; "
        "import slimt_jax.text.splitter as s; "
        "print(s.Splitter().split('Hello world. Bye now.'))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True, cwd=importlib.import_module("slimt_jax").__path__[0]
        + "/..",
    )
    assert out.stdout.strip() == "['Hello world.', 'Bye now.']"


def test_missing_tokenizers_falls_back(monkeypatch):
    """With `tokenizers` absent the vocabulary still encodes, through
    the native or the pure-Python segmenter, to the same ids."""
    from slimt_jax.text import spm_proto
    from slimt_jax.text.synthetic_vocab import DEFAULT_WORDS, build_spm_model
    from slimt_jax.text.vocabulary import Vocabulary

    blob = spm_proto.serialize_model(build_spm_model(DEFAULT_WORDS))
    want = Vocabulary(blob, backend="python").encode("hello world test")
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    vocab = Vocabulary(blob)
    assert vocab._hf is None
    assert vocab.encode("hello world test") == want
