"""End-to-end transcription + JSON dump (counterpart of the reference's
examples/test.rs: transcribe a WAV and write segments.json)."""

import json

from ..types import Callbacks, segments_to_json
from ._common import base_parser, make_engine, make_options


def main(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    engine = make_engine(args)
    cb = Callbacks(
        progress=lambda pct, kind, label: print(f"[{kind.value}] {pct}% {label}"),
        new_segment_callback=lambda seg: print(
            f"  -> [{seg.start:.2f}-{seg.end:.2f}] {seg.text!r}"),
    )
    cues = engine.transcribe_audio(args.audio, make_options(args), callbacks=cb)
    with open("segments.json", "w") as f:
        json.dump(segments_to_json(cues), f, indent=2, ensure_ascii=False)
    print(f"{len(cues)} cues written to segments.json")


if __name__ == "__main__":
    main()
