import sys

from jpeg_tpu_torch.cli import main

sys.exit(main())
