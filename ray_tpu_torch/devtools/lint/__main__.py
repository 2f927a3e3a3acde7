import sys

from ray_tpu_torch.devtools.lint.cli import main

if __name__ == "__main__":
    sys.exit(main())
