"""Delete a cached whisper model (counterpart of examples/delete_cached_model.rs)."""

import sys

from .. import delete_cached_model


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        print("usage: delete_cached_model.py <model> [cache_dir]")
        return
    model = argv[0]
    cache = argv[1] if len(argv) > 1 else "./cache"
    ok = delete_cached_model(cache, model)
    print(f"deleted {model!r}: {ok}")


if __name__ == "__main__":
    main()
