"""Count progress callbacks per ProgressType (counterpart of
examples/progress_types.rs: atomic counters per stage)."""

import collections

from ..types import Callbacks
from ._common import base_parser, make_engine, make_options


def main(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    engine = make_engine(args)
    counts = collections.Counter()
    cb = Callbacks(progress=lambda pct, kind, label: counts.update([kind.value]))
    engine.transcribe_audio(args.audio, make_options(args), callbacks=cb)
    for kind, n in counts.items():
        print(f"{kind}: {n} progress events")


if __name__ == "__main__":
    main()
