"""The plain reference the benchmark holds the program to: Whisper's
log-mel, encoder, cross K/V, teacher-forced decoder, alignment maps and
DTW (`whisper_ref.py`), and the diarization nets (`segmentation.py`,
`campplus.py`), in plain
PyTorch and NumPy, f32 with TF32 off, from weights drawn again from the
seed. Nothing here imports the program.

`lowp=True` runs the same arithmetic one step of precision lower, the
control the comparison has to refuse: every product of a bf16 stage with
fp8 e4m3 operands (weights a scale an output column, activations a scale a
row), and every product of an f32 stage in TF32.
"""
