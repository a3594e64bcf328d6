"""``python -m pollen_tpu_torch``: the ``fgfa-torch`` CLI."""

from .cli import main

if __name__ == "__main__":
    main()
