"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m benchmark.run`` from the root of the checkout).  The last
line of standard output is the JSON result; earlier lines break the set-up
time down and give the card, its power limit and the memory peak; the last
lines of standard error give each number of the output check beside its
limit.  Exits with 2 and prints no result without the CUDA devices the
cell asks for, and with 3 if a module of JAX or of the JAX package was
loaded.
"""
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
