"""`python -m realpdebench_tpu_torch` → the CLI."""

import sys

from realpdebench_tpu_torch.cli import main

if __name__ == "__main__":
    main(sys.argv[1:])
