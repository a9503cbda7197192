"""Run one cell of the benchmark once and print its result line.

    python3 ocr_bench/run.py --workload serve_attn_bulk --seed 7 --seconds 20 --trace 0

See ocr_bench/README.md.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ocr_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
