"""HTML markup extraction and restoration around translation.

Python implementation of the reference HTML transfer
(slimt/HTML.{hh,cc}):

  extraction — parse markup out of the input, keeping a list of
  `Span`s (byte ranges of the plain text × the stack of tags open
  there). Block-level tags insert sentence breaks ("\\n\\n" plus a
  WHITESPACE pseudo-tag), other non-inline tags insert word-break
  spaces; void/ignored/comment/PI nodes attach to empty spans
  (slimt/HTML.cc:385-559).

  restoration — map each source token to its span
  (`_restore_source`), hard-align target tokens to source tokens from
  the soft alignment matrices with word-continuation and
  markup-extension heuristics (`_hard_align`, slimt/HTML.cc:797-865),
  copy tag stacks across the alignment, then re-emit HTML around the
  target tokens, re-inserting skipped empty elements ("stragglers")
  (slimt/HTML.cc:660-718).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from slimt_jax.html import scanner as xh
from slimt_jax.text.annotation import AnnotatedText, Range

ELEMENT = "element"
VOID_ELEMENT = "void"
COMMENT = "comment"
PROCESSING_INSTRUCTION = "pi"
DOCTYPE = "doctype"
WHITESPACE = "whitespace"

VOID_TAGS = frozenset(
    "area base basefont bgsound br col embed frame hr img input keygen "
    "link meta param source track wbr".split()
)
INLINE_TAGS = frozenset(
    "abbr a b em i kbd mark math output q ruby small span strong sub sup "
    "time u var wbr ins del img".split()
)
IN_WORD_TAGS = frozenset(("wbr",))
IGNORED_TAGS = frozenset("code kbd samp var dir acronym math".split())
CONTINUATION_DELIMITERS = "\n ,.(){}[]"


@dataclasses.dataclass(eq=False)
class Tag:
    """Identity-compared markup node (slimt/HTML.hh:120-139)."""

    type: str
    name: str = ""
    attributes: str = ""
    data: str = ""


@dataclasses.dataclass
class Span:
    begin: int  # byte offsets into the plain text
    end: int
    tags: List[Tag]

    def size(self) -> int:
        return self.end - self.begin


def encode_entities(text: str) -> str:
    return text.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")


def _open_tag_html(tag: Tag) -> str:
    if tag.type in (ELEMENT, VOID_ELEMENT):
        return f"<{tag.name}{tag.attributes}>{tag.data}"
    if tag.type == COMMENT:
        return f"<!--{tag.data}-->"
    if tag.type == PROCESSING_INSTRUCTION:
        return f"<?{tag.data}?>"
    if tag.type == DOCTYPE:
        return f"<!{tag.data}>"
    return ""  # WHITESPACE handled separately


def diff_tags(prev: List[Tag], curr: List[Tag]):
    """Tags to close and open to go from stack `prev` to `curr`
    (slimt/HTML.cc:121-141)."""
    i = 0
    while i < len(prev):
        if i >= len(curr) or prev[i] is not curr[i]:
            break
        i += 1
    closing = [t for t in prev[i:] if t.type == ELEMENT]
    opening = list(curr[i:])
    return opening, closing


def _extends(b: List[Tag], a: List[Tag]) -> bool:
    """Is stack b == a with possibly more tags nested deeper?"""
    if len(a) > len(b):
        return False
    return all(x is y for x, y in zip(a, b))


def _count_prefix_whitespace(token: str) -> int:
    i = 0
    while i < len(token) and token[i].isspace():
        i += 1
    return i


class TokenFormatter:
    """Inserts open/close markup around a token, keeping closing tags
    left of the token and opening tags after its leading whitespace
    (slimt/HTML.cc:193-263)."""

    def __init__(self, token: str):
        self.html = encode_entities(token)
        self.offset = 0
        self.whitespace_offset = 0
        self.whitespace_size = _count_prefix_whitespace(token)
        self.close_left = True

    def append(self, prev: List[Tag], curr: List[Tag]) -> None:
        opening, closing = diff_tags(prev, curr)
        for tag in reversed(closing):
            close_tag = f"</{tag.name}>"
            at = self.offset + (0 if self.close_left else self.whitespace_size)
            self.html = self.html[:at] + close_tag + self.html[at:]
            self.offset += len(close_tag)
            if self.close_left:
                self.whitespace_offset += len(close_tag)
        for tag in opening:
            if tag.type == WHITESPACE:
                # Eat the \n\n paragraph break we inserted at extraction.
                pos = self.html.find("\n\n", self.whitespace_offset)
                if (
                    pos != -1
                    and pos < self.whitespace_offset + self.whitespace_size
                ):
                    self.html = self.html[:pos] + self.html[pos + 2 :]
                    self.whitespace_size -= 2
                open_tag = ""
            else:
                open_tag = _open_tag_html(tag)
            at = self.offset + self.whitespace_size
            self.html = self.html[:at] + open_tag + self.html[at:]
            self.offset += len(open_tag)
            self.close_left = self.close_left and not open_tag


def _is_continuation(prev: str, token: str) -> bool:
    if not prev or not token:
        return False
    return (
        token[0] not in CONTINUATION_DELIMITERS
        and prev[-1] not in CONTINUATION_DELIMITERS
    )


def _has_alignments(response) -> bool:
    for sid in range(response.target.sentence_count()):
        if sid >= len(response.alignments):
            return False
        if len(response.alignments[sid]) != response.target.word_count(sid):
            return False
        for row in response.alignments[sid]:
            if len(row) != response.source.word_count(sid):
                return False
    return True


class HTML:
    """Extracts markup on construction; `restore()` re-inserts it into
    a translated Response."""

    def __init__(self, source: str):
        self.spans: List[Span] = [Span(0, 0, [])]
        parts: List[str] = []
        nbytes = 0  # running byte length of the plain text

        stack: List[Tag] = []
        tag: Optional[Tag] = None
        add_sentence_break = False
        add_word_break = False

        def text_tail(k: int) -> str:
            tail = ""
            for part in reversed(parts):
                tail = part + tail
                if len(tail) >= k:
                    break
            return tail[-k:]

        def emit(text: str) -> None:
            nonlocal nbytes
            parts.append(text)
            nbytes += len(text.encode("utf-8"))

        for token in xh.scan(source, raw_nested=IGNORED_TAGS):
            kind = token[0]
            if kind == "text":
                value = token[1]
                if add_sentence_break:
                    if nbytes >= 2 and text_tail(2) != "\n\n":
                        stack.append(Tag(WHITESPACE))
                        self.spans.append(Span(nbytes, nbytes, list(stack)))
                        emit("\n\n")
                        stack.pop()
                    add_sentence_break = False
                if add_word_break:
                    if _is_continuation(text_tail(1), value):
                        emit(" ")
                    add_word_break = False
                begin = nbytes
                emit(value)
                self.spans.append(Span(begin, nbytes, list(stack)))
            elif kind == "tag_start":
                name = token[1].lower()
                tag = Tag(
                    VOID_ELEMENT if name in VOID_TAGS else ELEMENT,
                    name=token[1],
                    attributes=token[2],
                )
                stack.append(tag)
                if tag.type == VOID_ELEMENT:
                    self.spans.append(Span(nbytes, nbytes, list(stack)))
                    stack.pop()
                if name in IGNORED_TAGS:
                    # content will arrive via "data"/"tag_end"; treat as
                    # void-like: its own empty span
                    pass
                if name not in INLINE_TAGS:
                    add_sentence_break = True
                elif name not in IN_WORD_TAGS:
                    add_word_break = True
            elif kind == "tag_end":
                name = token[1].lower()
                if name in VOID_TAGS:
                    continue
                if not stack:
                    raise xh.BadHTML(
                        f"more closing tags (</{token[1]}>) than opening"
                    )
                if stack[-1].name.lower() != name:
                    raise xh.BadHTML(
                        f"unexpected closing tag </{token[1]}>"
                    )
                if not self.spans or not any(
                    t is stack[-1] for t in self.spans[-1].tags
                ):
                    self.spans.append(Span(nbytes, nbytes, list(stack)))
                stack.pop()
                if name not in INLINE_TAGS:
                    add_sentence_break = True
                elif name not in IN_WORD_TAGS:
                    add_word_break = True
            elif kind == "comment":
                tag = Tag(COMMENT, data=token[1])
                stack.append(tag)
                self.spans.append(Span(nbytes, nbytes, list(stack)))
                stack.pop()
            elif kind == "pi":
                tag = Tag(PROCESSING_INSTRUCTION, data=token[1])
                stack.append(tag)
                self.spans.append(Span(nbytes, nbytes, list(stack)))
                stack.pop()
            elif kind == "doctype":
                tag = Tag(DOCTYPE, data=token[1])
                stack.append(tag)
                self.spans.append(Span(nbytes, nbytes, list(stack)))
                stack.pop()
            elif kind == "data":
                assert tag is not None
                tag.data = token[1]

        if stack:
            names = ", ".join(t.name for t in stack)
            raise xh.BadHTML(f"not all tags were closed: {names}")
        self.spans.append(Span(nbytes, nbytes, []))
        self.source = "".join(parts)

    # -- restoration ---------------------------------------------------

    def restore(self, response) -> None:
        if not _has_alignments(response):
            raise ValueError(
                "Response has no alignments; HTML restore requires them"
            )

        source_token_spans: List[int] = []
        new_source = self._restore_source(response.source, source_token_spans)

        alignments = self._hard_align(response, source_token_spans)
        target_token_spans = self._copy_tag_stack(
            response, alignments, source_token_spans
        )
        target_token_tags = [
            self.spans[i].tags for i in target_token_spans
        ]
        new_target = self._restore_target(
            response.target, target_token_spans, target_token_tags
        )
        response.source = new_source
        response.target = new_target

    def _restore_source(
        self, annotated: AnnotatedText, source_token_spans: List[int]
    ) -> AnnotatedText:
        """Re-insert HTML into the source text; records the span index
        each token maps to (slimt/HTML.cc:613-658)."""
        span_idx = 0
        prev_idx = 0

        def fun(range_: Range, token: str, last: bool) -> str:
            nonlocal span_idx, prev_idx
            formatter = TokenFormatter(token)
            while True:
                formatter.append(
                    self.spans[prev_idx].tags, self.spans[span_idx].tags
                )
                prev_idx = span_idx
                if span_idx + 1 < len(self.spans) and (
                    self.spans[span_idx + 1].begin < range_.end or last
                ):
                    span_idx += 1
                    continue
                break
            source_token_spans.append(prev_idx)
            return formatter.html

        return annotated.apply(fun)

    def _hard_align(
        self, response, source_token_spans: List[int]
    ) -> List[List[int]]:
        """One source token per target token (slimt/HTML.cc:797-865)."""
        alignments: List[List[int]] = []
        offset = 0  # sentence offset in source_token_spans
        for sid in range(response.target.sentence_count()):
            rows = response.alignments[sid]
            n_target = response.target.word_count(sid)
            current: List[int] = []
            for t in range(max(n_target - 1, 0)):
                row = rows[t]
                current.append(max(range(len(row)), key=row.__getitem__))

            for t in range(1, max(n_target - 1, 0)):
                if _is_continuation(
                    response.target.word(sid, t - 1),
                    response.target.word(sid, t),
                ):
                    curr_s = current[t]
                    prev_s = current[t - 1]
                    curr_score = rows[t][curr_s]
                    prev_score = rows[t - 1][prev_s]
                    curr_tags = self.spans[
                        source_token_spans[offset + 1 + curr_s]
                    ].tags
                    prev_tags = self.spans[
                        source_token_spans[offset + 1 + prev_s]
                    ].tags
                    if _extends(curr_tags, prev_tags) or curr_score >= prev_score:
                        i = t
                        while True:
                            current[i] = curr_s
                            if i == 0 or not _is_continuation(
                                response.target.word(sid, i - 1),
                                response.target.word(sid, i),
                            ):
                                break
                            i -= 1
                    else:
                        current[t] = prev_s

            if n_target > 0:
                # target end always aligns with source end
                current.append(response.source.word_count(sid) - 1)
            alignments.append(current)
            offset += response.source.word_count(sid) + 1
        return alignments

    def _copy_tag_stack(
        self,
        response,
        alignments: List[List[int]],
        source_token_spans: List[int],
    ) -> List[int]:
        """Span index for every target token incl. gaps
        (slimt/HTML.cc:725-749)."""
        target_token_spans: List[int] = []
        offset = 0
        for sid in range(response.target.sentence_count()):
            target_token_spans.append(source_token_spans[offset])
            for t in range(response.target.word_count(sid)):
                s = alignments[sid][t]
                target_token_spans.append(source_token_spans[offset + 1 + s])
            offset += response.source.word_count(sid) + 1
        target_token_spans.append(source_token_spans[offset])
        return target_token_spans

    def _restore_target(
        self,
        annotated: AnnotatedText,
        target_token_spans: List[int],
        target_token_tags: List[List[Tag]],
    ) -> AnnotatedText:
        """Re-emit HTML around target tokens, inserting skipped empty
        elements (slimt/HTML.cc:660-718)."""
        previous_tags: List[Tag] = self.spans[0].tags
        straggler = 0
        cursor = 0
        token_span_set = set(target_token_spans)  # O(1) membership

        def fun(range_: Range, token: str, last: bool) -> str:
            nonlocal previous_tags, straggler, cursor
            formatter = TokenFormatter(token)
            while straggler < target_token_spans[cursor]:
                if (
                    self.spans[straggler].size() != 0
                    and straggler in token_span_set
                ):
                    straggler += 1
                    continue
                formatter.append(previous_tags, self.spans[straggler].tags)
                previous_tags = self.spans[straggler].tags
                straggler += 1

            formatter.append(previous_tags, target_token_tags[cursor])
            if last:
                formatter.append(target_token_tags[cursor], [])
            previous_tags = target_token_tags[cursor]
            cursor += 1
            return formatter.html

        return annotated.apply(fun)
