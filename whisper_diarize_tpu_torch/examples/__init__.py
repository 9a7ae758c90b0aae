"""Runnable examples of the port, each `python -m
whisper_diarize_tpu_torch.examples.<name>` (counterparts of the repository's
`examples/*.py`); every `main(argv=None)` takes its arguments as a list."""
