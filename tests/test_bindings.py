"""Python binding-surface tests (Service facade, to_json, iterators)."""

import json

import pytest

from slimt_jax.bindings import Service, sentences, to_json, words
from slimt_jax.text.annotation import Encoding

from .helpers import make_model


@pytest.fixture(scope="module")
def model():
    return make_model()


def test_service_facade(model):
    service = Service(workers=2, cache_size=64)
    try:
        responses = service.translate(model, ["hello world", "goodbye test"])
        assert len(responses) == 2
        assert responses[0].source.text == "hello world"
    finally:
        service.close()


def test_to_json(model):
    service = Service(workers=1, cache_size=0)
    try:
        response = service.translate(model, ["hello world"])[0]
    finally:
        service.close()
    data = json.loads(to_json(response))
    assert data["source"]["text"] == "hello world"
    assert isinstance(data["source"]["annotation"][0], list)
    assert "target" in data and "alignments" in data


def test_iterators(model):
    service = Service(workers=1, cache_size=0)
    try:
        response = service.translate(model, ["hello world\ngoodbye"])[0]
    finally:
        service.close()
    sids = [sid for sid, _, _ in sentences(response.source)]
    assert sids == [0, 1]
    surfaces = [surface for _, _, _, surface in words(response.source)]
    assert "".join(surfaces).startswith("hello world")


def test_response_encoding_round_trip(model):
    """byte ↔ utf8 annotation ranges reconstruct identical words
    (reference test_encoding.py)."""
    service = Service(workers=1, cache_size=0)
    try:
        response = service.translate(model, ["héllo wörld"])[0]
    finally:
        service.close()
    byte_words = [w for _, _, _, w in words(response.source)]
    response.to(Encoding.UTF8)
    utf8_words = [w for _, _, _, w in words(response.source)]
    assert byte_words == utf8_words
    response.to(Encoding.BYTE)
    assert byte_words == [w for _, _, _, w in words(response.source)]


def test_service_translate_defaults_to_utf8_ranges(model):
    """The facade converts Responses to UTF-8 ranges by default, like
    the reference pybind translate(..., encoding=UTF8)
    (bindings/python/slimt.cpp:54-83); encoding=None keeps the
    engine's native byte offsets."""
    text = "héllo wörld"
    service = Service(workers=1, cache_size=0)
    try:
        utf8 = service.translate(model, [text])[0]
        raw = service.translate(model, [text], encoding=None)[0]
        via_enum = service.translate(model, [text], encoding=Encoding.BYTE)[0]
    finally:
        service.close()
    assert utf8.source.encoding == Encoding.UTF8
    assert raw.source.encoding == Encoding.BYTE
    assert via_enum.source.encoding == Encoding.BYTE
    # é/ö are 2 bytes: the sentence end differs between encodings.
    assert (
        utf8.source.sentence_as_range(0).end
        < raw.source.sentence_as_range(0).end
    )


def test_patch_marian_for_slimt(tmp_path):
    """Reference utils.py:21-50 semantics: the serving keys are
    overridden, everything else survives, quality adds its pair."""
    import yaml

    from slimt_jax.bindings import patch_marian_for_slimt

    marian = tmp_path / "marian.yml"
    marian.write_text(
        "models: [model.intgemm8.bin]\n"
        "vocabs: [vocab.spm, vocab.spm]\n"
        "workspace: 9000\n"
        "beam-size: 1\n"
    )
    out = tmp_path / "slimt.yml"
    patch_marian_for_slimt(str(marian), str(out))
    data = yaml.safe_load(out.read_text())
    assert data["workspace"] == 128
    assert data["max-length-break"] == 128
    assert data["mini-batch-words"] == 1024
    assert data["ssplit-mode"] == "paragraph"
    assert data["alignment"] == "soft"
    assert data["beam-size"] == 1  # untouched keys survive
    assert data["models"] == ["model.intgemm8.bin"]
    assert "quality" not in data

    patch_marian_for_slimt(str(marian), str(out), quality=True)
    data = yaml.safe_load(out.read_text())
    assert data["quality"] is True and data["skip-cost"] is False
