"""``python -m psra_bench``: run one cell once (see ``psra_bench.run``)."""
import sys

from psra_bench.run import main

if __name__ == "__main__":
    sys.exit(main())
