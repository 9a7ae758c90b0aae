"""Transcribe then Google-translate the segments (counterpart of
examples/test_transcribe_translate.rs). Requires network for the translate
post-pass."""

import json

from ..types import segments_to_json
from ._common import base_parser, make_engine, make_options


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--to", default="de", help="translate target language")
    args = p.parse_args(argv)
    engine = make_engine(args)
    options = make_options(args)
    options.translate_target = args.to
    cues = engine.transcribe_audio(args.audio, options)
    print(json.dumps(segments_to_json(cues), indent=2, ensure_ascii=False))


if __name__ == "__main__":
    main()
