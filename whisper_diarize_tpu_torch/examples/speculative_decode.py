"""Speculative greedy decoding: a smaller draft checkpoint proposes tokens,
the target model verifies them — identical output, fewer target passes.

No reference counterpart (whisper.cpp has no speculative mode). The natural
pairing is `large-v3-turbo` drafting for `large-v3`: they share the
vocabulary and the (frozen) encoder, and the turbo decoder runs ~7x cheaper
per token.

    python -m whisper_diarize_tpu_torch.examples.speculative_decode audio.wav \\
        --model large-v3 --draft-model-dir /path/to/turbo-snapshot --greedy

The emitted tokens are always the TARGET's own greedy choices — a weak
draft only costs speed, never accuracy (`ops/speculative.py`).
"""

from ._common import base_parser, make_engine, make_options


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--draft-model-dir", required=True,
                   help="local snapshot of the (smaller) draft model")
    p.add_argument("--spec-gamma", type=int, default=4,
                   help="draft proposals per target verification pass")
    args = p.parse_args(argv)
    args.greedy = True  # speculative decoding is a greedy-strategy feature

    engine = make_engine(args, draft_model_path=args.draft_model_dir,
                         speculative_gamma=args.spec_gamma)
    cues = engine.transcribe_audio(args.audio, make_options(args))
    for c in cues:
        print(f"[{c.start:8.2f} - {c.end:8.2f}] {c.text}")


if __name__ == "__main__":
    main()
