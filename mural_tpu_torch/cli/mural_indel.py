"""mural_indel console entry on PyTorch/CUDA:
``python -m mural_tpu_torch.cli.mural_indel train ...``."""

import sys

from mural_tpu_torch.cli.main import main as _main


def main(argv=None) -> int:
    return _main("indel", argv)


if __name__ == "__main__":
    sys.exit(main())
