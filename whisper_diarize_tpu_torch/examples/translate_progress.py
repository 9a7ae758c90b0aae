"""Translate-stage progress reporting (counterpart of
examples/test_translate_progress.rs). Requires network access to the
Google endpoint."""

import sys

from ..translate import translate_segments
from ..types import Segment


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    segs = [Segment(i * 1.0, i * 1.0 + 1.0, f"sentence number {i}") for i in range(8)]
    events = []

    def progress(pct, kind, label):
        events.append(pct)
        print(f"[{kind.value}] {pct:3d}% {label}")

    translate_segments(segs, "en", argv[0] if argv else "de", progress=progress)
    print("first/last:", events[0], events[-1])


if __name__ == "__main__":
    main()
