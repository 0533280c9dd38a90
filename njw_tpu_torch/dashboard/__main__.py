import sys

from njw_tpu_torch.dashboard.server import main

if __name__ == "__main__":
    sys.exit(main())
