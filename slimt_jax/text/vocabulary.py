"""SentencePiece-compatible vocabulary.

The reference wraps the sentencepiece C++ library
(slimt/Vocabulary.cc:24-104): encode returns token ids plus byte-range
views into the source line; decode returns text plus per-token views.
This module reproduces that contract without the sentencepiece
dependency:

  - the serialized ModelProto is parsed by slimt_jax.text.spm_proto;
  - segmentation is unigram-LM Viterbi (pure Python backend), or the
    HuggingFace `tokenizers` Rust Unigram pipeline when available
    (much faster; used for batch encode on the serving path).

Both backends implement sentencepiece's preprocessing: optional NFKC-
style precompiled charsmap (HF backend only), whitespace escaping to
▁ (U+2581), dummy-prefix insertion, and extra-whitespace removal.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

from slimt_jax.text import spm_proto
from slimt_jax.text.spm_proto import (
    PIECE_BYTE,
    PIECE_CONTROL,
    PIECE_NORMAL,
    PIECE_UNKNOWN,
    PIECE_UNUSED,
    PIECE_USER_DEFINED,
    SpmModel,
)

SPACE = "▁"  # ▁
UNK_SURFACE = " ⁇ "  # sentencepiece's default unk_surface " ⁇ "


def byte_prefix(text: str) -> List[int]:
    """Char→byte offset table: byte_prefix(text)[i] is the UTF-8 byte
    offset of character i (one trailing entry = total byte length)."""
    prefix = [0]
    append = prefix.append
    total = 0
    for ch in text:
        total += len(ch.encode("utf-8"))
        append(total)
    return prefix


def _tile(ranges):
    """Force token byte-ranges to tile contiguously: bytes dropped by
    normalization (e.g. collapsed whitespace) attach to the *following*
    token, matching sentencepiece's full-coverage surface alignment
    that AnnotatedText.record_existing_sentence requires."""
    if not ranges:
        return ranges
    # Fast path: HF Metaspace offsets already tile on typical text —
    # verify without allocating per-token tuples.
    prev_end = ranges[0][1]
    for i in range(1, len(ranges)):
        begin, end = ranges[i]
        if begin != prev_end or end < begin:
            break
        prev_end = end
    else:
        return ranges
    out = [ranges[0]]
    for begin, end in ranges[1:]:
        prev_end = out[-1][1]
        out.append((prev_end, max(end, prev_end)))
    return out


class Vocabulary:
    """encode/decode with byte-range views (slimt/Vocabulary.hh:14-29)."""

    def __init__(self, serialized: bytes, backend: str = "auto"):
        self.serialized = bytes(serialized)  # kept for worker respawn
        self.model = spm_proto.parse_model(serialized)
        self.pieces = self.model.pieces
        self._ids = {p.piece: i for i, p in enumerate(self.pieces)}
        self._unk_id = self.model.unk_id if self.model.unk_id >= 0 else 0
        scores = [
            p.score
            for p in self.pieces
            if p.type in (PIECE_NORMAL, PIECE_USER_DEFINED)
        ]
        min_score = min(scores) if scores else 0.0
        self._unk_score = min_score - 10.0  # sentencepiece kUnkPenalty
        self._max_piece_len = max(
            (len(p.piece) for p in self.pieces), default=1
        )
        self._charsmap = None  # parsed lazily by _normalize
        self._hf = None
        if backend in ("auto", "hf"):
            try:
                self._hf = self._build_hf()
            except Exception:
                if backend == "hf":
                    raise
                self._hf = None
        # Native C++ segmenter (native/slimt_host.cpp). Implements the
        # full normalization, including the precompiled charsmap
        # (darts-trie longest-match, sentencepiece Normalizer
        # semantics) when the model ships one.
        self._native = None
        if backend in ("auto", "native"):
            try:
                from slimt_jax import native

                if native.available():
                    self._native = native.NativeVocab(
                        self.pieces, self._unk_id, self.model.normalizer
                    )
                elif backend == "native":
                    raise RuntimeError("native library unavailable")
            except Exception:
                if backend == "native":
                    raise
                self._native = None

    @property
    def resolved_batch_backend(self) -> str:
        """The backend the *batch* encode path uses — ingest worker
        processes must build the same one so tokenizations match
        bit-for-bit. Preference: the C++ batch segmenter (one
        multithreaded call, flat-array outputs — no per-token Python
        objects) over HF tokenizers (fast Rust encode, but offset
        extraction crosses one Python tuple per token), overridable
        with SLIMT_JAX_BATCH_BACKEND=hf|native. The backends are
        parity-tested to tokenize identically (tests/test_native.py)."""
        import os

        forced = os.environ.get("SLIMT_JAX_BATCH_BACKEND", "")
        if forced == "hf" and self._hf is not None:
            return "hf"
        if forced == "native" and self._native is not None:
            return "native"
        if self._native is not None:
            return "native"
        if self._hf is not None:
            return "hf"
        return "none"

    # -- basic ids ----------------------------------------------------

    def __len__(self) -> int:
        return len(self.pieces)

    @property
    def size(self) -> int:
        return len(self.pieces)

    @property
    def eos_id(self) -> int:
        return self.model.eos_id if self.model.eos_id >= 0 else 0

    @property
    def pad_id(self) -> int:
        # Clamped non-negative like the reference (slimt/Vocabulary.hh:23).
        return max(0, self.model.pad_id)

    @property
    def unk_id(self) -> int:
        return self._unk_id

    def id_of(self, piece: str) -> int:
        return self._ids.get(piece, self._unk_id)

    # -- normalization -------------------------------------------------

    def _normalize(self, text: str) -> Tuple[str, List[int]]:
        """Returns (normalized, byte_alignment) where byte_alignment[i]
        is the byte offset in the *original* text for normalized char i
        (plus one trailing entry = len(original bytes))."""
        ns = self.model.normalizer
        char_orig = None  # with a charsmap: per char of `text2`, orig pos
        if ns.precompiled_charsmap:
            if self._charsmap is None:
                from slimt_jax.text.charsmap import Charsmap

                self._charsmap = Charsmap(ns.precompiled_charsmap)
            data = text.encode("utf-8")
            norm_bytes, byte_align = self._charsmap.apply(data)
            text2 = norm_bytes.decode("utf-8", errors="replace")
            # per-char origin = alignment of the char's first byte
            char_orig = []
            bp = 0
            for ch in text2:
                char_orig.append(byte_align[bp] if bp < len(byte_align) else len(data))
                bp += len(ch.encode("utf-8"))
            orig_len = len(data)
            return self._normalize_chars(text2, char_orig, orig_len, ns)
        out = []
        align = []
        byte_pos = 0
        chars = list(text)
        # remove_extra_whitespaces: strip leading/trailing, collapse runs.
        keep = [True] * len(chars)
        if ns.remove_extra_whitespaces:
            i = 0
            while i < len(chars) and chars[i] == " ":
                keep[i] = False
                i += 1
            j = len(chars) - 1
            while j >= 0 and chars[j] == " ":
                keep[j] = False
                j -= 1
            prev_space = False
            for k in range(i, j + 1):
                if chars[k] == " ":
                    if prev_space:
                        keep[k] = False
                    prev_space = True
                else:
                    prev_space = False
        first = True
        for ch, k in zip(chars, keep):
            nbytes = len(ch.encode("utf-8"))
            if k:
                if first and ns.add_dummy_prefix:
                    out.append(SPACE if ns.escape_whitespaces else " ")
                    align.append(byte_pos)
                first = False
                if ch == " " and ns.escape_whitespaces:
                    ch = SPACE
                out.append(ch)
                align.append(byte_pos)
            byte_pos += nbytes
        if first and ns.add_dummy_prefix and out == []:
            pass  # empty input stays empty
        align.append(len(text.encode("utf-8")))
        return "".join(out), align

    @staticmethod
    def _normalize_chars(
        text: str, char_orig: List[int], orig_len: int, ns
    ) -> Tuple[str, List[int]]:
        """The whitespace half of normalization over charsmap output:
        identical space handling to _normalize, but each char's origin
        comes from `char_orig` (the charsmap alignment) instead of its
        own byte position."""
        out = []
        align = []
        chars = list(text)
        keep = [True] * len(chars)
        if ns.remove_extra_whitespaces:
            i = 0
            while i < len(chars) and chars[i] == " ":
                keep[i] = False
                i += 1
            j = len(chars) - 1
            while j >= 0 and chars[j] == " ":
                keep[j] = False
                j -= 1
            prev_space = False
            for k in range(i, j + 1):
                if chars[k] == " ":
                    if prev_space:
                        keep[k] = False
                    prev_space = True
                else:
                    prev_space = False
        first = True
        for ch, k, pos in zip(chars, keep, char_orig):
            if k:
                if first and ns.add_dummy_prefix:
                    out.append(SPACE if ns.escape_whitespaces else " ")
                    align.append(pos)
                first = False
                if ch == " " and ns.escape_whitespaces:
                    ch = SPACE
                out.append(ch)
                align.append(pos)
        align.append(orig_len)
        return "".join(out), align

    # -- pure python Viterbi ------------------------------------------

    def _viterbi(self, normalized: str) -> List[Tuple[int, int, int]]:
        """Unigram Viterbi segmentation.

        Returns [(piece_id, start, end)] over `normalized` (char
        offsets)."""
        n = len(normalized)
        if n == 0:
            return []
        best = [-math.inf] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)
        best[0] = 0.0
        ids = self._ids
        pieces = self.pieces
        max_len = self._max_piece_len
        for start in range(n):
            if best[start] == -math.inf:
                continue
            base = best[start]
            found_single = False
            for end in range(start + 1, min(n, start + max_len) + 1):
                candidate = normalized[start:end]
                pid = ids.get(candidate)
                if pid is None:
                    continue
                piece = pieces[pid]
                if piece.type in (PIECE_CONTROL, PIECE_UNKNOWN, PIECE_UNUSED):
                    continue
                if end == start + 1:
                    found_single = True
                score = base + piece.score
                if score > best[end]:
                    best[end] = score
                    back[end] = (pid, start)
            if not found_single:
                # unknown single char
                score = base + self._unk_score
                if score > best[start + 1]:
                    best[start + 1] = score
                    back[start + 1] = (self._unk_id, start)
        # backtrack
        result = []
        pos = n
        while pos > 0:
            pid, start = back[pos]
            result.append((pid, start, pos))
            pos = start
        result.reverse()
        # merge consecutive unknowns into one token (sentencepiece
        # behavior: adjacent unknown chars form a single <unk> span)
        merged: List[Tuple[int, int, int]] = []
        for pid, start, end in result:
            if (
                merged
                and pid == self._unk_id
                and merged[-1][0] == self._unk_id
                and merged[-1][2] == start
            ):
                merged[-1] = (pid, merged[-1][1], end)
            else:
                merged.append((pid, start, end))
        return merged

    # -- HF tokenizers backend ----------------------------------------

    def _build_hf(self):
        from tokenizers import Tokenizer, decoders, normalizers, pre_tokenizers
        from tokenizers.models import Unigram

        ns = self.model.normalizer
        vocab = [(p.piece, p.score) for p in self.pieces]
        tok = Tokenizer(Unigram(vocab, self._unk_id, False))
        from tokenizers import Regex

        norm_chain = []
        if ns.precompiled_charsmap:
            norm_chain.append(normalizers.Precompiled(ns.precompiled_charsmap))
        if ns.remove_extra_whitespaces:
            norm_chain.append(normalizers.Replace(Regex(" {2,}"), " "))
            norm_chain.append(normalizers.Strip())
        tok.normalizer = (
            normalizers.Sequence(norm_chain) if norm_chain else None
        )
        prepend = "first" if ns.add_dummy_prefix else "never"
        tok.pre_tokenizer = pre_tokenizers.Metaspace(
            replacement=SPACE, prepend_scheme=prepend
        )
        tok.decoder = decoders.Metaspace(
            replacement=SPACE, prepend_scheme=prepend
        )
        return tok

    # -- public encode/decode -----------------------------------------

    def encode(
        self, line: str, add_eos: bool = False
    ) -> Tuple[List[int], List[Tuple[int, int]]]:
        """line → (ids, byte ranges into `line`); views do NOT cover the
        appended EOS (slimt/Vocabulary.cc:34-75)."""
        if self._native is not None:
            ids, ranges = self._native.encode(line)
        elif self._hf is not None:
            ids, ranges = self._encode_hf(line)
        else:
            ids, ranges = self._encode_py(line)
        if add_eos:
            ids = ids + [self.eos_id]
        return ids, _tile(ranges)

    def encode_batch(
        self, lines: Sequence[str], add_eos: bool = False
    ) -> List[Tuple[List[int], List[Tuple[int, int]]]]:
        """Parallel batch encode (Rust backend releases the GIL)."""
        if self._hf is not None:
            encs = self._hf.encode_batch(list(lines), add_special_tokens=False)
            out = []
            for line, enc in zip(lines, encs):
                ids, ranges = self._convert_hf(line, enc)
                if add_eos:
                    ids = ids + [self.eos_id]
                out.append((ids, _tile(ranges)))
            return out
        return [self.encode(line, add_eos) for line in lines]

    def encode_batch_begins(
        self, lines: Sequence[str]
    ) -> List[Tuple[List[int], List[int], int]]:
        """Batch encode returning (ids, token begin offsets, end) per
        line — the serving ingest fast path. Because token ranges tile
        contiguously (the _tile contract), the full range list is
        redundant: begins plus the final end reconstruct it. Extracting
        just the begins runs at C speed (zip/tuple compare), skipping
        ~1 tuple allocation per token vs encode_batch."""
        if self.resolved_batch_backend == "native":
            return self._native.encode_batch_begins(lines)
        if self._hf is None:
            out = []
            for line in lines:
                ids, ranges = self.encode(line)
                if ranges:
                    b, e = zip(*ranges)
                    out.append((ids, list(b), e[-1]))
                else:
                    out.append((ids, [], 0))
            return out
        encs = self._hf.encode_batch(list(lines), add_special_tokens=False)
        out = []
        for line, enc in zip(lines, encs):
            offsets = enc.offsets
            if not offsets:
                out.append((enc.ids, [], 0))
                continue
            b, e = zip(*offsets)  # C-speed unzip
            # Contiguity + monotonicity check, all C-speed: tiles iff
            # each begin equals the previous end and begins ascend
            # (timsort's run detection makes sorted() O(n) here).
            if not (
                b[1:] == e[:-1] and e[-1] >= b[-1] and list(b) == sorted(b)
            ):
                b, e = zip(*_tile(offsets))
            end = e[-1]
            data = line.encode("utf-8")
            if len(data) != len(line):  # non-ASCII: char → byte offsets
                prefix = byte_prefix(line)
                out.append((enc.ids, [prefix[x] for x in b], prefix[end]))
            else:
                out.append((enc.ids, list(b), end))
        return out

    def _encode_py(self, line: str):
        normalized, align = self._normalize(line)
        segs = self._viterbi(normalized)
        ids = [pid for pid, _, _ in segs]
        ranges = []
        for _, start, end in segs:
            b0 = align[start]
            b1 = align[end] if end < len(align) else align[-1]
            ranges.append((b0, b1))
        return ids, ranges

    def _encode_hf(self, line: str):
        enc = self._hf.encode(line, add_special_tokens=False)
        return self._convert_hf(line, enc)

    def _convert_hf(self, line: str, enc):
        # HF offsets are char offsets into the original line → bytes.
        data = line.encode("utf-8")
        if len(data) == len(line):  # pure-ASCII fast path: chars == bytes
            # .ids/.offsets each materialize a fresh list per access —
            # no defensive copy needed.
            return enc.ids, enc.offsets
        prefix = byte_prefix(line)
        ranges = [
            (prefix[b], prefix[e]) for b, e in enc.offsets
        ]
        return list(enc.ids), ranges

    def decode_batch(
        self, segments: Sequence[Sequence[int]]
    ) -> List[Tuple[bytes, List[int]]]:
        """Decode many segments at once: per segment (UTF-8 bytes,
        per-token end offsets; tokens contiguous from 0). One native
        library call when available — the fast path device batches
        take through Batch.complete."""
        if self._native is not None:
            return self._native.decode_batch(segments)
        out = []
        for words in segments:
            text, ranges = self.decode(words, ignore_eos=False)
            out.append((text.encode("utf-8"), [e for _, e in ranges]))
        return out

    def decode(
        self, words: Sequence[int], ignore_eos: bool = False
    ) -> Tuple[str, List[Tuple[int, int]]]:
        """ids → (text, per-token byte ranges into text)
        (slimt/Vocabulary.cc:77-104). Control pieces surface as empty
        ranges; unknown ids as sentencepiece's unk_surface."""
        if self._native is not None:
            text, ranges = self._native.decode(words)
            if ignore_eos and ranges:
                last_begin = ranges[-1][0]
                ranges = ranges[:-1]
                text = text.encode("utf-8")[:last_begin].decode(
                    "utf-8", errors="replace"
                )
            return text, ranges
        out = []
        ranges = []
        byte_pos = 0
        first_real = True
        for word in words:
            if 0 <= word < len(self.pieces):
                piece = self.pieces[word]
                if piece.type == PIECE_CONTROL:
                    surface = ""
                elif piece.type == PIECE_UNKNOWN:
                    # unk_surface participates in the leading-space
                    # strip like any real piece — otherwise a leading
                    # <unk> keeps its space AND eats the next word's.
                    surface = UNK_SURFACE
                    if first_real and surface.startswith(" "):
                        surface = surface[1:]
                    first_real = False
                elif piece.type == PIECE_BYTE:
                    surface = ""  # byte-fallback pieces re-assembled upstream
                else:
                    surface = piece.piece.replace(SPACE, " ")
                    if first_real and surface.startswith(" "):
                        surface = surface[1:]
                    first_real = False
            else:
                surface = UNK_SURFACE
                if first_real and surface.startswith(" "):
                    surface = surface[1:]
                first_real = False
            encoded = surface.encode("utf-8")
            out.append(surface)
            ranges.append((byte_pos, byte_pos + len(encoded)))
            byte_pos += len(encoded)
        if ignore_eos and ranges:
            ranges.pop()
            out.pop()
        return "".join(out), ranges
