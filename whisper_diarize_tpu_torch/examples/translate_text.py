"""Standalone text translation (counterpart of examples/translate-test.rs).
Requires network access to the Google endpoint."""

import sys

from ..translate import translate_text


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    text = argv[0] if len(argv) > 0 else "Hello, how are you?"
    src = argv[1] if len(argv) > 1 else "en"
    dst = argv[2] if len(argv) > 2 else "de"
    print(translate_text(text, src, dst))


if __name__ == "__main__":
    main()
