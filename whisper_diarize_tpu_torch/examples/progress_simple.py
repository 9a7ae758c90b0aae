"""Throttled single-line progress rendering (counterpart of
examples/progress_simple.rs)."""

import time

from ..types import Callbacks
from ._common import base_parser, make_engine, make_options


def main(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    engine = make_engine(args)
    last = [0.0]

    def progress(pct, kind, label):
        now = time.time()
        if now - last[0] > 0.25 or pct == 100:
            print(f"\r{label}: {pct:3d}%", end="", flush=True)
            last[0] = now

    cues = engine.transcribe_audio(args.audio, make_options(args),
                                   callbacks=Callbacks(progress=progress))
    print(f"\ndone: {len(cues)} cues")


if __name__ == "__main__":
    main()
