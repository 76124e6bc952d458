"""Python-API conveniences mirroring the reference's python package.

The reference wraps its C++ service in pybind11 plus a pure-python
layer (bindings/python/): a `Service` facade, `to_json`, and
word/sentence iterators (bindings/python/utils.py:54-75,
iterators.py). Since this framework is Python-native those just live
here.

`patch_marian_for_slimt` adapts a marian-training YAML for this
engine (reference utils.py:21-50 semantics); `package_from_config`
reads translateLocally `config.*.yml` manifests to locate artifact
files when present. Network model repositories live in
slimt_jax/repository.py (offline-graceful).
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional, Tuple

from slimt_jax.models.model import Package
from slimt_jax.runtime.response import Response
from slimt_jax.text.annotation import AnnotatedText, Range


class Service:
    """Facade matching the reference pybind surface
    (bindings/python/slimt.cpp:144-221): Service(workers, cache_size)
    with list-in/list-out translate and pivot."""

    def __init__(self, workers: int = 1, cache_size: int = 1024):
        from slimt_jax.config import Config
        from slimt_jax.runtime.response import Options
        from slimt_jax.runtime.service import Async

        self._options_cls = Options
        self._service = Async(
            Config(workers=workers, cache_size=cache_size)
        )

    def translate(
        self,
        model,
        texts,
        html: bool = False,
        alignment: bool = None,
        encoding="utf8",
    ):
        """alignment defaults to the reference pybind behavior
        (requested only when html needs it); pass True to force
        alignments into the Responses (the C ABI's as_json path).
        `encoding` converts annotation ranges like the reference's
        translate(..., encoding) (bindings/python/slimt.cpp:54-83,
        default UTF8 there too): Encoding.UTF8/BYTE or the strings
        "utf8"/"byte"; None keeps the engine's native byte ranges."""
        if alignment is None:
            alignment = html
        options = self._options_cls(html=html, alignment=alignment)
        handles = self._service.translate_many(model, list(texts), options)
        responses = [handle.result() for handle in handles]
        return _convert_encoding(responses, encoding)

    def translate_bulk(
        self, model, texts, html: bool = False, encoding="utf8"
    ):
        """List-in/list-out translate via the bulk corpus path (same
        Responses, ~2x host throughput — see
        runtime/bulk.translate_bulk). Lazily shares one Blocking
        service (and its translation cache) across calls."""
        from slimt_jax.runtime.service import Blocking

        if not hasattr(self, "_bulk"):
            self._bulk = Blocking(self._service.config)
            self._bulk.cache = self._service.cache  # shared cache
        options = self._options_cls(html=html, alignment=html)
        responses = self._bulk.translate_bulk(model, list(texts), options)
        return _convert_encoding(responses, encoding)

    def pivot(
        self, first, second, texts, html: bool = False, encoding="utf8"
    ):
        options = self._options_cls(html=html, alignment=True)
        handles = [
            self._service.pivot(first, second, text, options)
            for text in texts
        ]
        responses = [handle.result() for handle in handles]
        return _convert_encoding(responses, encoding)

    def close(self):
        self._service.close()
        if hasattr(self, "_bulk"):
            self._bulk.close()


def _convert_encoding(responses, encoding):
    """In-place Response.to(encoding); accepts Encoding or its string
    value, returns the list for chaining."""
    if encoding is None:
        return responses
    from slimt_jax.text.annotation import Encoding

    if isinstance(encoding, str):
        encoding = Encoding(encoding.lower())
    for response in responses:
        response.to(encoding)
    return responses


def to_json(response: Response, *args, **kwargs) -> str:
    """Response → JSON (reference bindings/python/utils.py:54-75)."""

    def annotated(text: AnnotatedText):
        result = []
        for sid in range(text.sentence_count()):
            result.append(
                [
                    tuple(text.word_as_range(sid, wid))
                    for wid in range(text.word_count(sid))
                ]
            )
        return {"text": text.text, "annotation": result}

    return json.dumps(
        {
            "source": annotated(response.source),
            "target": annotated(response.target),
            "alignments": list(response.alignments),
        },
        *args,
        **kwargs,
    )


def words(text: AnnotatedText, sentence_id: Optional[int] = None):
    """Iterate (sentence_id, word_id, range, surface) like the
    reference WordIterator (bindings/python/iterators.py)."""
    sentences = (
        range(text.sentence_count())
        if sentence_id is None
        else [sentence_id]
    )
    for sid in sentences:
        for wid in range(text.word_count(sid)):
            yield sid, wid, text.word_as_range(sid, wid), text.word(sid, wid)


def sentences(text: AnnotatedText):
    """Iterate (sentence_id, range, surface)."""
    for sid in range(text.sentence_count()):
        yield sid, text.sentence_as_range(sid), text.sentence(sid)


def package_from_config(path: str) -> Package:
    """Build a Package from a translateLocally-style config.*.yml
    manifest next to the artifact files (reference
    bindings/python/utils.py package_from_config_path)."""
    keys = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if ":" in line and not line.startswith("#"):
                key, _, value = line.partition(":")
                keys[key.strip()] = value.strip().strip("\"'")

    root = os.path.dirname(os.path.abspath(path))

    def resolve(key):
        name = keys.get(key)
        if not name:
            return None
        value = name.split()[0] if " " in name else name
        candidate = os.path.join(root, value)
        return candidate if os.path.exists(candidate) else None

    models = keys.get("models", "") or keys.get("model", "")
    model = resolve("model") or os.path.join(
        root, models.strip("[] ").split(",")[0].strip()
    )
    vocab = resolve("vocab") or resolve("vocabs") or resolve("srcvocab")
    return Package(
        model=model,
        vocabulary=vocab,
        shortlist=resolve("shortlist"),
        ssplit=resolve("ssplit-prefix-file"),
    )


def patch_marian_for_slimt(
    marian_config_path: str,
    slimt_config_path: str,
    quality: bool = False,
) -> None:
    """Adapt a marian-training YAML (post-quantization) for engine
    use: override the serving-relevant entries the reference hardcodes
    (reference bindings/python/utils.py:21-50 — identical keys and
    values, so a config patched by either implementation is
    interchangeable)."""
    import yaml

    with open(marian_config_path, encoding="utf-8") as f:
        data = yaml.safe_load(f) or {}

    data.update(
        {
            "ssplit-prefix-file": "",
            "ssplit-mode": "paragraph",
            "max-length-break": 128,
            "mini-batch-words": 1024,
            # Shipped models carry big workspaces; keep it low.
            "workspace": 128,
            "alignment": "soft",
        }
    )
    if quality:
        data.update({"quality": quality, "skip-cost": False})

    with open(slimt_config_path, "w", encoding="utf-8") as output_file:
        print(yaml.dump(data, sort_keys=False), file=output_file)
