"""Property/fuzz tests for the HTML pipeline (scanner → extract →
translate → restore), mirroring the test_fuzz.py style for the text
pipeline.

Invariants checked (the reference offers no spec beyond "round-trips
sensibly"; these are the structural guarantees HTML.restore relies
on, slimt/HTML.cc:385-779):
  - scan() on arbitrary byte soup terminates and raises at most
    ScanError;
  - well-formed generated markup survives the full service path with
    balanced tags in BOTH restored texts and no text content lost.
"""

import random
import re
import string

import pytest

from slimt_jax.config import Config
from slimt_jax.html.html import HTML, IGNORED_TAGS, VOID_TAGS
from slimt_jax.html.scanner import BadHTML, ScanError, scan
from slimt_jax.runtime.response import Options
from slimt_jax.runtime.service import Blocking

from .helpers import make_model

# Text alphabet avoids markup metacharacters; entity/metachar torture
# is the garbage fuzz's job.
_WORD_CHARS = string.ascii_letters + string.digits + "äöüñ中文"
_INLINE = ["b", "i", "em", "strong", "u", "span", "a", "mark"]
_BLOCK = ["p", "div", "li", "h1", "td"]
_VOIDS = ['<br/>', '<img src="x.png"/>', '<hr/>', '<wbr/>']


def _words(rng, lo=1, hi=5):
    return " ".join(
        "".join(rng.choice(_WORD_CHARS) for _ in range(rng.randint(1, 8)))
        for _ in range(rng.randint(lo, hi))
    )


def _markup(rng, depth=0):
    parts = []
    for _ in range(rng.randint(1, 3 if depth else 5)):
        r = rng.random()
        if r < 0.45 or depth >= 3:
            parts.append(_words(rng))
        elif r < 0.53:
            parts.append(rng.choice(_VOIDS))
        elif r < 0.58:
            parts.append(f"<!--{_words(rng, 1, 2)}-->")
        else:
            tag = rng.choice(_INLINE if r < 0.85 else _BLOCK)
            attrs = (
                f' class="c{rng.randint(0, 9)}"' if rng.random() < 0.3 else ""
            )
            parts.append(
                f"<{tag}{attrs}>{_markup(rng, depth + 1)}</{tag}>"
            )
    return " ".join(parts)


def _tag_balance(markup):
    """Scan `markup` and return the leftover open-tag stack (ignoring
    void elements, which never close). Raises if a close tag does not
    match the innermost open tag."""
    stack = []
    for token in scan(markup, raw_nested=IGNORED_TAGS):
        if token[0] == "tag_start":
            if token[1].lower() not in VOID_TAGS:
                stack.append(token[1].lower())
        elif token[0] == "tag_end":
            name = token[1].lower()
            if name in VOID_TAGS:
                continue
            assert stack and stack[-1] == name, (
                f"close </{name}> with stack {stack} in {markup!r}"
            )
            stack.pop()
    return stack


def _text_content(markup):
    out = []
    for token in scan(markup, raw_nested=IGNORED_TAGS):
        if token[0] in ("text", "data"):
            out.append(token[1])
    return re.sub(r"\s+", "", "".join(out))


def test_generated_markup_is_wellformed():
    """Sanity: the generator only emits balanced markup."""
    rng = random.Random(5)
    for _ in range(50):
        assert _tag_balance(_markup(rng)) == []


def test_extract_preserves_text_content():
    rng = random.Random(11)
    for _ in range(60):
        markup = _markup(rng)
        html = HTML(markup)
        # html.source is the stripped text fed to translation: all of
        # the markup's text, none of its tags.
        assert re.sub(r"\s+", "", html.source) == _text_content(markup)
        assert "<" not in html.source


def test_service_roundtrip_balanced_and_lossless():
    """Full pipeline on generated markup: both restored texts must
    re-scan with balanced tags; the restored SOURCE must carry exactly
    the original text content (the reference guarantee — target text
    is translated, so only its structure is checked)."""
    model = make_model()
    service = Blocking(Config(cache_size=0))
    rng = random.Random(23)
    markups = [_markup(rng) for _ in range(24)]
    responses = service.translate(model, list(markups), Options(html=True))
    for markup, response in zip(markups, responses):
        assert _tag_balance(response.source.text) == []
        assert _tag_balance(response.target.text) == []
        assert _text_content(response.source.text) == _text_content(markup)


def test_scanner_garbage_terminates():
    """Arbitrary metacharacter soup: scan() must terminate, raising at
    most ScanError (never hang, never another exception type)."""
    alphabet = string.ascii_letters + " <>&\"'/!?-=;#\n\tİß中"
    rng = random.Random(31)
    for _ in range(400):
        soup = "".join(
            rng.choice(alphabet) for _ in range(rng.randint(0, 120))
        )
        try:
            for _token in scan(soup, raw_nested=frozenset({"a"})):
                pass
        except ScanError:
            pass


def test_html_extract_garbage_is_contained():
    """HTML() on soup either succeeds (and strips every tag) or raises
    BadHTML (scanner or extractor flavor); it must never corrupt state
    or raise anything else."""
    alphabet = string.ascii_letters + " <>&\"'/!?-=;\n"
    rng = random.Random(37)
    built = 0
    for _ in range(300):
        soup = "".join(
            rng.choice(alphabet) for _ in range(rng.randint(0, 100))
        )
        try:
            html = HTML(soup)
        except BadHTML:
            continue
        built += 1
        # stray '<' / decoded &lt; may appear as TEXT; the structural
        # invariant is the span bookkeeping restore depends on: byte
        # offsets monotone, within the stripped text, terminal
        # empty-stack span present.
        nbytes = len(html.source.encode("utf-8"))
        prev = 0
        for span in html.spans:
            assert 0 <= span.begin <= span.end <= nbytes
            assert span.begin >= prev
            prev = span.begin
        assert html.spans and html.spans[-1].tags == []
    assert built > 20  # the fuzz actually exercises successful parses


@pytest.mark.parametrize(
    "markup",
    [
        "<p>a<b>b</b>c</p>",
        "<ul><li>x</li><li>y</li></ul>",
        '<a href="h">link</a> tail',
        "<div><br/>only void</div>",
        "<p></p>empty element",
        "<code>kept &amp; raw</code> after",  # IGNORED_TAGS member
    ],
)
def test_known_shapes_roundtrip(markup):
    model = make_model()
    service = Blocking(Config(cache_size=0))
    response = service.translate(model, [markup], Options(html=True))[0]
    assert _tag_balance(response.source.text) == []
    assert _tag_balance(response.target.text) == []
    assert _text_content(response.source.text) == _text_content(markup)
