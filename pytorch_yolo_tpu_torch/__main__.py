"""``python -m pytorch_yolo_tpu_torch`` == the ``pytorch-yolo-tpu-torch`` console script."""

import sys

if __name__ == "__main__":
    from .cli import main

    sys.exit(main())
