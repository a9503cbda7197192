"""The traffic generators are functions of the seed."""
import numpy as np

from ocr_bench import gen


def test_receipts_repeat_per_seed():
    a = gen.receipts(np.random.default_rng(9), 2, 60, 40)
    b = gen.receipts(np.random.default_rng(9), 2, 60, 40)
    c = gen.receipts(np.random.default_rng(10), 2, 60, 40)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert a[0].shape == (60, 40, 3) and a[0].dtype == np.uint8


def test_words_repeat_per_seed_and_are_distinct():
    a = gen.words(np.random.default_rng(3), 50, "abc0", 3, 12)
    assert a == gen.words(np.random.default_rng(3), 50, "abc0", 3, 12)
    assert len(set(a)) == 50 and all(3 <= len(w) <= 12 for w in a)
    font = gen.glyph_font("abc0", 3)
    x = gen.word_image(a[0], font, np.random.default_rng(1))
    assert np.array_equal(x, gen.word_image(a[0], gen.glyph_font("abc0", 3), np.random.default_rng(1)))
    assert x.shape == (32, 11 * len(a[0]) + 6)

