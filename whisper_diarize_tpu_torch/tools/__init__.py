"""The port's tools, each run as `python -m whisper_diarize_tpu_torch.tools.<name>`:
the diagnostic tools `bench_dma` (the card's stream rate, K11) and
`bench_attn_kernel` (K1 taken apart, K9); the decode breakdown tools
`bench_decode_breakdown`, `bench_beam_breakdown`, `bench_layer_variants`,
`bench_beam_variants` and `bench_quant_kv`; the converter CLI
`convert_models`; and `timing`, how they and `chip_smoke.py` time a kernel
or a phase."""
