"""Property tests for the pivot alignment remap
(slimt/Response.cc:22-175 semantics).

The two pivot-leg models tokenize the SAME pivot text differently;
`transfer_through_characters` redistributes P(q'|t) over the second
tokenization into P(q|t) over the first by byte overlap. For any two
monotone tilings of the same byte extent, probability mass must be
conserved row-by-row, and the composed P(s|t) must stay row-stochastic.
"""

import random

import pytest

from slimt_jax.runtime.response import (
    Response,
    remap_alignments,
    transfer_through_characters,
)
from slimt_jax.text.annotation import Range


def _random_tiling(rng, nbytes, zero_width_tail=False):
    """A monotone tiling of [0, nbytes) into 1..nbytes ranges, with an
    optional zero-width terminal token (an EOS with empty surface)."""
    cuts = sorted(
        rng.sample(range(1, nbytes), rng.randint(0, min(nbytes - 1, 12)))
    )
    bounds = [0] + cuts + [nbytes]
    ranges = [
        Range(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)
    ]
    if zero_width_tail:
        ranges.append(Range(nbytes, nbytes))
    return ranges


def _row_stochastic(rng, rows, cols):
    matrix = []
    for _ in range(rows):
        row = [rng.random() for _ in range(cols)]
        total = sum(row) or 1.0
        matrix.append([v / total for v in row])
    return matrix


@pytest.mark.parametrize("zero_width_tail", [False, True])
def test_transfer_conserves_mass(zero_width_tail):
    rng = random.Random(13)
    for _ in range(80):
        nbytes = rng.randint(2, 60)
        first = _random_tiling(rng, nbytes, zero_width_tail)
        second = _random_tiling(rng, nbytes, zero_width_tail)
        n_t = rng.randint(1, 6)
        p_qt = _row_stochastic(rng, n_t, len(second))
        remapped = transfer_through_characters(first, second, p_qt)
        assert len(remapped) == n_t
        for t in range(n_t):
            assert len(remapped[t]) == len(first)
            assert sum(remapped[t]) == pytest.approx(1.0, abs=1e-9)
            assert all(v >= -1e-12 for v in remapped[t])


def test_transfer_identical_tilings_is_identity():
    rng = random.Random(17)
    for _ in range(20):
        nbytes = rng.randint(2, 40)
        tiling = _random_tiling(rng, nbytes)
        p_qt = _row_stochastic(rng, 3, len(tiling))
        remapped = transfer_through_characters(tiling, tiling, p_qt)
        for t in range(3):
            assert remapped[t] == pytest.approx(p_qt[t])


def test_transfer_unmatched_trailing_tokens_gifted():
    """Second tokenization extends past the first (the reference's
    unpredicted-EOS case, slimt/Response.cc:78-96): trailing mass is
    spread uniformly, still conserving the row total."""
    first = [Range(0, 4)]
    second = [Range(0, 4), Range(4, 4), Range(4, 4)]
    p_qt = [[0.5, 0.25, 0.25]]
    remapped = transfer_through_characters(first, second, p_qt)
    assert remapped == [pytest.approx([1.0])]


def test_transfer_empty_first_leg_drops_mass():
    """A first leg that decoded to zero tokens has nowhere to put
    mass — must not divide by zero."""
    remapped = transfer_through_characters([], [Range(0, 3)], [[1.0]])
    assert remapped == [[]]


class _FakeAnnotated:
    """Minimal AnnotatedText stand-in: one sentence, given word
    ranges."""

    def __init__(self, ranges):
        self._ranges = ranges

    def sentence_count(self):
        return 1

    def word_count(self, sid):
        return len(self._ranges)

    def word_as_range(self, sid, wid):
        return self._ranges[wid]


def test_remap_composition_is_row_stochastic():
    """P(s|t) = Σ_q P(s|q)·P(q|t): with both factors row-stochastic
    over two tilings of the same pivot text, every output row must sum
    to 1 (slimt/Response.cc:129-175)."""
    rng = random.Random(29)
    for _ in range(40):
        nbytes = rng.randint(2, 50)
        n_source = rng.randint(1, 5)
        n_target = rng.randint(1, 5)
        first_pivot = _random_tiling(rng, nbytes)
        second_pivot = _random_tiling(rng, nbytes)

        first = Response()
        first.source = _FakeAnnotated([Range(0, 1)] * n_source)
        first.target = _FakeAnnotated(first_pivot)
        first.alignments = [
            _row_stochastic(rng, len(first_pivot), n_source)
        ]

        second = Response()
        second.source = _FakeAnnotated(second_pivot)
        second.target = _FakeAnnotated([Range(0, 1)] * n_target)
        second.alignments = [
            _row_stochastic(rng, n_target, len(second_pivot))
        ]

        (matrix,) = remap_alignments(first, second)
        assert len(matrix) == n_target
        for row in matrix:
            assert len(row) == n_source
            assert sum(row) == pytest.approx(1.0, abs=1e-9)
