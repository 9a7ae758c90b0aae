"""The port's diagnostic tools: `bench_dma` (the card's stream rate, K11)
and `bench_attn_kernel` (K1 taken apart, K9), each run as
`python -m whisper_diarize_tpu_torch.tools.<name>`; `timing`, how they and
`chip_smoke.py` time a kernel."""
