"""`python -m gaot3d_tpu_torch`: the command line of `cli.py`."""
from .cli import main

if __name__ == "__main__":
    main()
