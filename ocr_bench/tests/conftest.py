"""The CRAFT training cell at a CPU's size for the tests that run every cell
(``tiny.py`` and ``faults.py`` were written before its driver): two 64x96
canvases a step, the checked step among the window's first two, and the
training faults planted in the CRAFT step as well as in the CRNN step."""
from __future__ import annotations

import copy

from ocr_bench import faults, faults_craft, harness
from ocr_bench.tests import tiny

TINY_CRAFT = {"batch": 2, "height": 64, "width": 96, "max_words": 8, "check_within": 2, "trace_seconds": 1}
_pieces = tiny.pieces


def pieces(cell: str) -> dict:
    p = copy.deepcopy(harness.find_cell(harness.load_json(harness.ROOT / "BENCHMARK.json"), cell))
    if p["traffic"]["driver"] != "craft_loop":
        return _pieces(cell)
    p["traffic"].update(TINY_CRAFT)
    return p


tiny.pieces = pieces
faults.TRAINING = tuple(faults_craft.also_in_craft(f) for f in faults.TRAINING)
