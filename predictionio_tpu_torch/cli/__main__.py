"""``python -m predictionio_tpu_torch.cli``: the port's ``pio`` console."""

import sys

from predictionio_tpu_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
