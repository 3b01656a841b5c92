"""``python -m cookietts_tpu_torch train ...`` (see cli.py); under torchrun
the rank leaves its process group at the end."""
from .cli import main
from .parallel import shutdown

if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown()
