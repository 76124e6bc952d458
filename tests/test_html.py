"""HTML scanner, extraction, and restore tests."""

import pytest

from slimt_jax.config import Config
from slimt_jax.html import HTML
from slimt_jax.html import scanner as xh
from slimt_jax.runtime.response import Options
from slimt_jax.runtime.service import Blocking

from .helpers import make_model


# --- scanner ---------------------------------------------------------


def test_scan_text_and_tags():
    tokens = list(xh.scan("<b>Hello</b> world"))
    assert tokens == [
        ("tag_start", "b", ""),
        ("text", "Hello"),
        ("tag_end", "b"),
        ("text", " world"),
    ]


def test_scan_attributes():
    tokens = list(xh.scan('<a href="x" id=\'y\' checked>z</a>'))
    assert tokens[0] == ("tag_start", "a", ' href="x" id="y" checked=""')


def test_scan_entities():
    (token,) = xh.scan("a &amp; b &lt;c&gt; &#65; &unknown;")
    assert token == ("text", "a & b <c> A &unknown;")


def test_scan_comment_and_pi():
    tokens = list(xh.scan("<!-- note -->x<?php hi ?>"))
    assert tokens == [("comment", " note "), ("text", "x"), ("pi", "php hi ")]


def test_scan_self_closing():
    tokens = list(xh.scan("a<br/>b"))
    assert tokens == [
        ("text", "a"),
        ("tag_start", "br", ""),
        ("tag_end", "br"),
        ("text", "b"),
    ]


def test_scan_script_raw():
    tokens = list(xh.scan("<script>if (a<b) x();</script>after"))
    assert tokens == [
        ("tag_start", "script", ""),
        ("data", "if (a<b) x();"),
        ("tag_end", "script"),
        ("text", "after"),
    ]


def test_scan_raw_nested():
    tokens = list(
        xh.scan("<code>a<code>b</code>c</code>d", raw_nested=frozenset(["code"]))
    )
    assert tokens == [
        ("tag_start", "code", ""),
        ("data", "a<code>b</code>c"),
        ("tag_end", "code"),
        ("text", "d"),
    ]


# --- extraction ------------------------------------------------------


def test_extract_plain_text():
    html = HTML("<b>hello</b> <i>world</i>")
    assert html.source == "hello world"


def test_extract_block_tags_insert_breaks():
    html = HTML("<p>one</p><p>two</p>")
    assert html.source == "one\n\ntwo"


def test_extract_word_break_spaces():
    html = HTML("un<u>der</u>line")
    # inline <u> substitutes spaces inside words
    assert html.source == "un der line"


def test_extract_no_space_before_punctuation():
    html = HTML("<strong>word</strong>. next")
    assert html.source == "word. next"


def test_extract_keeps_void_elements_in_spans():
    html = HTML("a<img src='x'>b")
    # img is inline → word-break space is substituted between a and b
    assert html.source == "a b"
    img_spans = [
        s for s in html.spans if any(t.name == "img" for t in s.tags)
    ]
    assert len(img_spans) == 1
    assert img_spans[0].size() == 0


def test_extract_unbalanced_raises():
    with pytest.raises(ValueError):
        HTML("<b>never closed")
    with pytest.raises(ValueError):
        HTML("no opening</b>")


def test_extract_ignored_tag_content_not_translated():
    html = HTML("run <code>x &lt; y</code> now")
    assert "x" not in html.source.replace("run", "").replace("now", "")
    code_tags = [
        t
        for s in html.spans
        for t in s.tags
        if t.name.lower() == "code"
    ]
    assert code_tags and "x &lt; y" in code_tags[0].data


# --- end-to-end restore ----------------------------------------------


@pytest.fixture(scope="module")
def model():
    return make_model()


def test_restore_through_service(model):
    service = Blocking(Config(cache_size=0))
    responses = service.translate(
        model, ["<b>hello</b> world"], Options(html=True)
    )
    response = responses[0]
    # source got its markup back
    assert "<b>" in response.source.text and "</b>" in response.source.text
    # target output contains balanced markup
    target = response.target.text
    assert target.count("<b>") == target.count("</b>")


def test_restore_void_element_stragglers(model):
    service = Blocking(Config(cache_size=0))
    response = service.translate(
        model, ["hello <img src='x.png'> world"], Options(html=True)
    )[0]
    assert "<img" in response.source.text
    assert "<img" in response.target.text


def test_restore_entity_encoding(model):
    service = Blocking(Config(cache_size=0))
    response = service.translate(
        model, ["five &lt; six"], Options(html=True)
    )[0]
    assert "&lt;" in response.source.text


def test_restore_multiparagraph(model):
    """Block tags create sentence breaks; restore re-emits the
    paragraph structure across multiple sentences."""
    service = Blocking(Config(cache_size=0))
    response = service.translate(
        model, ["<p>hello world</p><p>goodbye test</p>"], Options(html=True)
    )[0]
    src = response.source.text
    assert src.count("<p>") == 2 and src.count("</p>") == 2
    tgt = response.target.text
    assert tgt.count("<p>") == tgt.count("</p>")
    # both paragraphs survive in the target
    assert tgt.count("<p>") >= 1


def test_restore_nested_inline(model):
    service = Blocking(Config(cache_size=0))
    response = service.translate(
        model, ["<b><i>hello</i> world</b>"], Options(html=True)
    )[0]
    src = response.source.text
    assert src.index("<b>") < src.index("<i>") < src.index("</i>") < src.index("</b>")
    tgt = response.target.text
    for tag in ("<b>", "</b>"):
        assert tag in tgt
    # nesting order preserved where present
    if "<i>" in tgt:
        assert tgt.index("<i>") < tgt.index("</i>")


def test_comment_and_pi_preserved(model):
    service = Blocking(Config(cache_size=0))
    response = service.translate(
        model, ["<!-- note -->hello world"], Options(html=True)
    )[0]
    assert "<!-- note -->" in response.source.text
    assert "<!-- note -->" in response.target.text


def test_doctype_passthrough(model):
    """<!DOCTYPE html> must survive extract + restore verbatim (it was
    re-emitted as a <?...?> processing instruction)."""
    service = Blocking(Config(cache_size=0))
    response = service.translate(
        model, ["<!DOCTYPE html><p>hello</p>"], Options(html=True)
    )[0]
    assert "<!DOCTYPE html>" in response.source.text
    assert "<!DOCTYPE html>" in response.target.text
    assert "<?" not in response.target.text


def test_attribute_entities_kept_raw(model):
    """Attribute values keep their entities: decoding without
    re-escaping would let a quote terminate the attribute early."""
    service = Blocking(Config(cache_size=0))
    response = service.translate(
        model, ['<a title="say &quot;hi&quot;">hello</a>'], Options(html=True)
    )[0]
    assert 'title="say &quot;hi&quot;"' in response.target.text


def test_surrogate_numeric_entity_is_kept_literal():
    """&#55296; (a lone surrogate) cannot be encoded to UTF-8 — keep
    the entity text instead of crashing."""
    from slimt_jax.html.html import HTML

    html = HTML("<p>a &#55296; b</p>")
    assert "&#55296;" in html.source


def test_length_changing_lowercase_in_special_tag():
    """Tag searches fold case WITHOUT changing string length ('İ'
    lowercases to two chars) — indices must stay aligned and scan must
    terminate."""
    from slimt_jax.html.scanner import scan

    tokens = list(scan("İ<script>a</script>z"))
    kinds = [t[0] for t in tokens]
    assert kinds == ["text", "tag_start", "data", "tag_end", "text"]
    assert tokens[2][1] == "a"
    assert tokens[4][1] == "z"
