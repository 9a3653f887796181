"""Run one cell of the benchmark once and print its result line:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the repository's root on a machine with a CUDA card. The module
imports nothing at its top: the reference's worker processes import it
again when they start.
"""

import sys

if __name__ == "__main__":
    from perfbench.harness import main, process_start

    sys.exit(main(sys.argv[1:], t_process=process_start()))
