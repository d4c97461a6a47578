import sys

from r2d2_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
