"""The CPU rehearsal of a run at the tiny preset: a sound run comes out
`correct`, and so does no run with the timed path broken underneath (a
token altered where it is produced, half of a batch's rows left out, a
decode step that returns its state unchanged, an answer altered: the DTW
anchors, the segmentation net's output, the embeddings), nor the controls
(the reference one step of precision lower in the program's place; the
program's own int8 cross K/V path). The harness loads nothing of JAX."""

import contextlib
import logging

import pytest

from benchmark import rehearse

logging.getLogger("whisper_diarize_tpu_torch").setLevel(logging.ERROR)


@contextlib.contextmanager
def patched(owner, name, make):
    old = getattr(owner, name)
    setattr(owner, name, make(old))
    try:
        yield
    finally:
        setattr(owner, name, old)


def token_altered():
    from whisper_diarize_tpu_torch.ops import decode as dec

    def make(orig):
        def beam_sample(s, *args, **kwargs):
            step = s["step"]
            tok, src = orig(s, *args, **kwargs)
            if step == 2:  # every beam's token: the kept hypothesis holds one
                tok = (tok + 7) % 256
                s["tokens"][:, step] = tok
            return tok, src
        return beam_sample
    return patched(dec, "beam_sample", make)


def half_batch():
    from whisper_diarize_tpu_torch.transcribe import TranscribeStep

    def make(orig):
        def mel(step, audio):
            out = orig(step, audio[: audio.shape[0] // 2])
            return out.repeat(2, 1, 1)[: audio.shape[0]]
        return mel
    return patched(TranscribeStep, "mel", make)


def state_unchanged():
    from whisper_diarize_tpu_torch.models import whisper as wm

    def make(orig):
        first = {}

        def decode_step_split(*args, **kwargs):
            out = orig(*args, **kwargs)
            return first.setdefault(out.shape, out)
        return decode_step_split
    return patched(wm, "decode_step_split", make)


def anchors_altered():
    from whisper_diarize_tpu_torch.ops import dtw

    def make(orig):
        def anchors(*args, **kwargs):
            return orig(*args, **kwargs) + 25
        return anchors
    return patched(dtw, "dtw_anchor_frames_batch", make)


def seg_altered():
    from whisper_diarize_tpu_torch.models import segmentation

    def make(orig):
        def forward(*args, **kwargs):
            out = orig(*args, **kwargs)
            return out.roll(1, dims=-1)
        return forward
    return patched(segmentation, "forward", make)


def emb_altered():
    from whisper_diarize_tpu_torch.models import campplus

    def make(orig):
        def embed(*args, **kwargs):
            return orig(*args, **kwargs).flip(0)
        return embed
    return patched(campplus, "embed_from_audio", make)


BEAM = "large-v3.beam5.b16"
DIARIZE = "large-v3-turbo.diarize.b16"


@pytest.mark.parametrize("workload", [BEAM, DIARIZE])
def test_sound_rehearsal_is_correct(workload):
    out = rehearse.rehearse(rehearse.rehearsal_cell(workload), seed=2**31 + 11)
    assert out["error"] is None and out["correct"], out["checks"]
    assert out["banned"] == []
    assert out["metrics"]["xrt"]["value"] == "not measured"
    assert out["metrics"]["batch_fill"]["value"] > 0


def test_every_seed_does_the_same_work():
    """The traffic's handling fixes the work: the same windows whatever the
    weights' seed (each window decodes its token count and seeks 30 s)."""
    sp = rehearse.rehearsal_cell(BEAM)
    runs = [rehearse.rehearse(sp, seed=s) for s in (1, 2**31 + 77)]
    assert runs[0]["windows"] == runs[1]["windows"] == 6


@pytest.mark.parametrize("workload,fault,number", [
    (BEAM, token_altered, "logp_rms"),
    (BEAM, half_batch, "mel_err"),
    (BEAM, state_unchanged, "logp_rms"),
    (BEAM, anchors_altered, "anchor_cost"),
    (DIARIZE, seg_altered, "seg_err"),
    (DIARIZE, emb_altered, "emb_err"),
])
def test_broken_path_is_not_correct(workload, fault, number):
    with fault():
        out = rehearse.rehearse(rehearse.rehearsal_cell(workload), seed=5)
    assert not out["correct"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


@pytest.mark.parametrize("workload", [BEAM, DIARIZE])
@pytest.mark.parametrize("control", ["lowp", "int8_kv"])
def test_controls_are_not_correct(workload, control):
    out = rehearse.rehearse(rehearse.rehearsal_cell(workload), seed=9, **{control: True})
    assert not out["correct"], out["checks"]
