"""Deleting a model that isn't cached returns False, no exception
(counterpart of examples/test_delete_nonexistent.rs)."""

import sys

from .. import delete_cached_model


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    ok = delete_cached_model(argv[0] if argv else "./cache", "definitely-not-a-model")
    if ok is not False:
        raise AssertionError(f"delete of a nonexistent model returned {ok!r}")
    print("delete of nonexistent model correctly returned False")


if __name__ == "__main__":
    main()
