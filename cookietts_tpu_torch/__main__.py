"""``python -m cookietts_tpu_torch train ...`` (see cli.py)."""
from .cli import main

if __name__ == "__main__":
    main()
