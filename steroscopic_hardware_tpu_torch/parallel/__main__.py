"""``python -m steroscopic_hardware_tpu_torch.parallel``: see ``dryrun``."""

import sys

from steroscopic_hardware_tpu_torch.parallel.dryrun import main

if __name__ == "__main__":
    sys.exit(main())
