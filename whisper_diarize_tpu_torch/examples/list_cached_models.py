"""List cached whisper models (counterpart of examples/list_cached_models.rs)."""

import sys

from .. import list_cached_models


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cache = argv[0] if argv else "./cache"
    models = list_cached_models(cache)
    if not models:
        print("no cached models")
    for m in models:
        print(m)


if __name__ == "__main__":
    main()
