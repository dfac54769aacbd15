"""``python -m webradio_tpu_torch`` — run the SDR server on the CUDA device
(the main.cxx analog; ``--platform cpu`` serves on the CPU)."""

import sys

from .app import main

if __name__ == "__main__":
    sys.exit(main())
