"""The offline quality goldens of `tests/test_quality_fixture.py`, on the
port, at the JAX goldens' own bounds:

* (a) word-timestamp MAE <= 20 ms of the port's DTW anchors (the host path,
  the device path's plain version and `token_anchor_times`) against the
  independent torch replica `evals/torch_refs.py::dtw_anchor_times_torch`
  on identical attention;
* (b) `tools/run_config.py` config 2 (DTW word timestamps, subtitle
  formatting, the fallback ladder, VAD) replayed on the committed
  `tests/fixtures/quality/expected.txt` / `expected_words.json`, which the
  JAX pipeline made: WER == 0, `word_mae_aligned`, MAE <= 0.020 s, xRT > 0.
  The ladder samples from the JAX package's own random bits
  (`ops/prng.py`), so the port replays the JAX pipeline's text;
* (c) the DER golden through config 3: two speakers found, no false alarm,
  confusion <= 0.05, DER <= 0.65.

The checkpoint is the JAX package's `init_random_snapshot` (seed 0, the
golden's config); the port's `tools/quality_golden.write_snapshot` writes
the same values (checked here).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from whisper_diarize_tpu.models import weights as jweights
from whisper_diarize_tpu.models import whisper as jwm
from whisper_diarize_tpu_torch.tools import quality_golden as qg
from whisper_diarize_tpu_torch.tools import run_config

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "evals"))

torch.set_num_threads(2)
FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "quality")


def _jax_snapshot(path) -> str:
    jweights.init_random_snapshot(str(path), cfg=jwm.WhisperConfig(**qg.TINY_CFG_KW),
                                  seed=qg.SEED)
    return str(path)


def _report(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_dtw_word_mae_vs_torch_replica():
    """MAE of the port's anchors vs the replica on identical attention
    (target <= 20 ms; the implementations share semantics, so only float
    reduction order and backtrack ties can part them)."""
    from torch_refs import dtw_anchor_times_torch
    from whisper_diarize_tpu_torch.models import whisper as wm
    from whisper_diarize_tpu_torch.ops import decode as dec
    from whisper_diarize_tpu_torch.ops import dtw as tdtw
    from whisper_diarize_tpu_torch.ops.mel import log_mel_spectrogram
    from whisper_diarize_tpu_torch.tokenizer import DebugTokenizer

    cfg = wm.WhisperConfig(**qg.TINY_CFG_KW)
    params = wm.init_params(cfg, seed=3)
    tk = DebugTokenizer()
    sp = tk.specials
    rng = np.random.default_rng(0)
    B, n_valid = 2, 16000 * 3  # 3 s of audio -> 150 valid encoder frames
    audio = np.zeros((B, 480000), np.float32)
    audio[:, :n_valid] = rng.standard_normal((B, n_valid)).astype(np.float32) * 0.1
    xa = wm.encode(params, log_mel_spectrogram(torch.from_numpy(audio), n_mels=cfg.n_mels), cfg)

    # printable text tokens only, so the token sequence is non-trivial
    printable = [i for i in range(cfg.n_vocab) if i not in range(33, 127)]
    suppress = torch.from_numpy(dec.build_suppress_mask(sp, cfg.n_vocab, printable))
    dc = dec.DecodeConfig(max_tokens=16, blank_id=32, with_timestamps=False)
    prompt = torch.tensor([tk.sot_sequence(language="en")] * B, dtype=torch.long)
    res = dec.greedy_decode(params, cfg, dc, sp, xa, prompt, prompt.shape[1],
                            suppress_mask=suppress)
    lens = res.lengths.numpy()
    assert (lens > 0).all()
    seq = torch.cat([prompt, res.tokens], dim=1)
    qk = wm.alignment_cross_attn(params, cfg, seq, xa, wm.alignment_heads_for("", cfg)).numpy()
    n_frames, sot_len = n_valid // 320, prompt.shape[1]

    for b in range(B):
        n_tok = int(lens[b])
        n_rows = sot_len + n_tok + 1  # sot + text + the eot row, as the step
        cost_dev = tdtw.alignment_cost_batch(torch.from_numpy(qk[b][None]),
                                             torch.tensor([n_frames]), torch.tensor([n_rows]))
        cost = cost_dev[0, sot_len: sot_len + n_tok, :n_frames].numpy()
        anchors_host = tdtw.anchor_times_from_cost(np.ascontiguousarray(cost), n_tok)
        frames = tdtw.dtw_anchor_frames_batch(cost_dev, [n_tok], [n_frames], sot_len)
        anchors_dev = frames[0, :n_tok].numpy() * tdtw.FRAME_SECONDS
        anchors_ref = dtw_anchor_times_torch(qk[b][:, :n_rows, :], n_frames,
                                             sot_len=sot_len, n_tok=n_tok)
        text_qk = qk[b][:, sot_len: sot_len + n_tok, :]
        anchors_util = tdtw.token_anchor_times(text_qk, n_frames)
        anchors_ref_sliced = dtw_anchor_times_torch(text_qk, n_frames)
        for got, ref in ((anchors_host, anchors_ref), (anchors_dev, anchors_ref),
                         (anchors_util, anchors_ref_sliced)):
            assert float(np.abs(got - ref).mean()) <= 0.020 + 1e-9, (b, got, ref)
        np.testing.assert_array_equal(anchors_dev, anchors_host)


def test_port_snapshot_is_the_golden_checkpoint(tmp_path):
    """`write_snapshot` (the port's init, the JAX init's numpy draws) gives
    the checkpoint the goldens were made on."""
    from whisper_diarize_tpu_torch.models import weights

    ref, _ = weights.load_model(_jax_snapshot(tmp_path / "jax"), device="cpu")
    got, _ = weights.load_model(qg.write_snapshot(str(tmp_path / "port")), device="cpu")
    flat = lambda p, pre="": (  # noqa: E731
        [kv for k, v in p.items() for kv in flat(v, f"{pre}{k}.")] if isinstance(p, dict)
        else [(pre, p)])
    a, b = dict(flat(ref)), dict(flat(got))
    assert a.keys() == b.keys() and len(a) > 20
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_run_config_emits_wer_and_word_mae(tmp_path, capsys, monkeypatch):
    """Config 2 replayed on the committed golden: WER == 0 against
    expected.txt, word-timestamp MAE <= 20 ms against expected_words.json."""
    golden_txt = os.path.join(FIXTURE_DIR, "expected.txt")
    golden_words = os.path.join(FIXTURE_DIR, "expected_words.json")
    snap, wav = qg.build_fixture_inputs(str(tmp_path), _jax_snapshot(tmp_path / "snap"))
    monkeypatch.setenv("WDT_VAD_MODEL", "__random__")
    undo = qg.apply_printable_suppression()  # the generator's patch
    try:
        rc = run_config.main([
            "2", wav, "--model-dir", snap, "--cache-dir", str(tmp_path / "cache"),
            "--ref-text", golden_txt, "--ref-words", golden_words,
            "--max-tokens", str(qg.MAX_TOKENS), "--cpu",
        ])
    finally:
        undo()
    assert rc == 0
    report = _report(capsys)
    assert report["wer"] == 0.0, report
    assert report["word_mae_aligned"], report
    assert report["word_mae_s"] <= 0.020, report
    assert report["xRT"] > 0


def test_run_config_emits_der_golden(tmp_path, capsys, monkeypatch):
    """Config 3 on the two-speaker WAV against its designed RTTM: every
    chunk of a speaker in one cluster (speakers 2, confusion <= 5%), no
    speech outside the design (false alarm 0); DER <= 0.65, its main term
    the untrained segmentation net's missed speech."""
    snap, wav, rttm = qg.build_der_fixture_inputs(str(tmp_path),
                                                  _jax_snapshot(tmp_path / "snap"))
    monkeypatch.setenv("WDT_SEG_MODEL", "__random__")
    monkeypatch.setenv("WDT_EMB_MODEL", "__random__")
    undo = qg.apply_der_suppression()
    try:
        rc = run_config.main([
            "3", wav, "--model-dir", snap, "--cache-dir", str(tmp_path / "cache"),
            "--ref-rttm", rttm, "--max-tokens", "8",
            "--diarize-threshold", str(qg.DER_THRESHOLD),
            "--max-speakers", str(qg.DER_MAX_SPEAKERS), "--cpu",
        ])
    finally:
        undo()
    assert rc == 0
    report = _report(capsys)
    assert report["speakers_found"] == 2, report
    assert report["der"]["false_alarm"] == 0.0, report
    assert report["der"]["confusion"] <= 0.05, report
    assert report["der"]["der"] <= 0.65, report
