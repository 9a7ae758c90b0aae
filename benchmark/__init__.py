"""The benchmark of `whisper_diarize_tpu_torch` on one NVIDIA H100.

`python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one JSON
line last. Everything that belongs to one configuration, traffic mix,
per-layer metric or cell sits in a file of its own, found by name:
`configs/<config>.json`, `traffic/<traffic>.json`, `metrics/<metric>.py`,
`limits/<cell>.json`. The yardstick (traffic generation, the reduction of
the device trace, the operation and byte counts, the peaks, the plain
reference and the comparison that decides `correct`) lives here and
imports nothing of the program but its entry point and the functions the
spans wrap.
"""
