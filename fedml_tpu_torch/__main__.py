"""`python -m fedml_tpu_torch`: the unified launcher (cli.py)."""
import sys

from fedml_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
