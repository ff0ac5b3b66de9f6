"""``python -m apex_tpu_torch.checkpoint verify <dir>`` — checkpoint fsck."""

import sys

from apex_tpu_torch.checkpoint.verify import main

if __name__ == "__main__":
    sys.exit(main())
