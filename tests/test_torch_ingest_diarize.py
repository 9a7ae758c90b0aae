"""The port's ONNX weight converters against the JAX package's, and the
converted weights through the port's nets.

ONNX files come from the real torch.onnx exporter run over the independent
torch replicas of `evals/torch_refs.py` (PyanNet, and CAM++ with random
BatchNorm statistics so that the exporter's conv + BN fusion matters),
exported as `tests/test_ingest.py` does it. The port's
`segmentation_npz_from_onnx` / `campplus_npz_from_onnx` and its state-dict
mappers must give the JAX converters' arrays exactly; the port's nets on
the converted weights must reproduce the replicas (segmentation 2e-4,
CAM++ 5e-4, as the JAX package's own ingest tests hold its nets).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from whisper_diarize_tpu.models import convert as jcv
from whisper_diarize_tpu_torch.models import campplus, segmentation
from whisper_diarize_tpu_torch.models import convert as tcv

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "evals"))
from torch_refs import _build_torch_campplus, _build_torch_pyannet  # noqa: E402

torch.set_num_threads(2)


def _export_onnx(model, example, path):
    """torch.onnx.export without the `onnx` package (its last step only
    rewrites custom onnxscript functions, absent here, but imports onnx)."""
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    orig = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes
    try:
        torch.onnx.export(model, example, str(path), dynamo=False)
    finally:
        onnx_proto_utils._add_onnxscript_fn = orig


def _randomize_bn_stats(model):
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                mod.running_mean.normal_(0, 0.5)
                mod.running_var.uniform_(0.5, 2.0)
                if mod.affine:
                    mod.weight.normal_(1.0, 0.2)
                    mod.bias.normal_(0, 0.2)


@pytest.fixture(scope="module")
def pyannet(tmp_path_factory):
    """(replica, its .onnx path)."""
    torch.manual_seed(3)
    net = _build_torch_pyannet(torch).eval()
    path = tmp_path_factory.mktemp("seg") / "segmentation-3.0.onnx"
    _export_onnx(net, torch.randn(1, 1, 32000), path)
    return net, path


@pytest.fixture(scope="module")
def campnet(tmp_path_factory):
    torch.manual_seed(5)
    net = _build_torch_campplus(torch).eval()
    _randomize_bn_stats(net)
    path = tmp_path_factory.mktemp("cp") / "wespeaker_en_voxceleb_CAM++.onnx"
    _export_onnx(net, torch.randn(1, 398, 80), path)
    return net, path


def _assert_same_arrays(got, ref):
    assert sorted(got) == sorted(ref) and len(ref) > 10
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("net", ["segmentation", "campplus"])
def test_onnx_converter_matches_jax(pyannet, campnet, net):
    path = (pyannet if net == "segmentation" else campnet)[1]
    convert = f"{net}_npz_from_onnx"
    _assert_same_arrays(getattr(tcv, convert)(path), getattr(jcv, convert)(path))


@pytest.mark.parametrize("net", ["pyannote", "campplus"])
def test_state_mapper_matches_jax(pyannet, campnet, net):
    model = (pyannet if net == "pyannote" else campnet)[0]
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    got, ref = (getattr(m, f"map_{net}_state")(sd) for m in (tcv, jcv))
    _assert_same_arrays(got[0], ref[0])
    assert got[1:] == ref[1:]


def test_converted_segmentation_reproduces_the_replica(pyannet, tmp_path):
    net, path = pyannet
    x = torch.randn(2, 1, 32000, generator=torch.Generator().manual_seed(1)) * 0.1
    with torch.no_grad():
        ref = net(x).numpy()
    npz = tmp_path / "seg.npz"
    np.savez(npz, **tcv.segmentation_npz_from_onnx(path))
    with torch.inference_mode():
        got = segmentation.forward(segmentation.load_params(str(npz)), x[:, 0]).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)


def test_converted_campplus_reproduces_the_replica(campnet, tmp_path):
    net, path = campnet
    x = torch.randn(2, 398, 80, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref = net(x).numpy()
    npz = tmp_path / "cp.npz"
    np.savez(npz, **tcv.campplus_npz_from_onnx(path))
    with torch.inference_mode():
        got = campplus.embed_from_fbank(campplus.load_params(str(npz)), x,
                                        torch.ones(2, 398)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-4)


@pytest.mark.parametrize("net", ["segmentation", "campplus"])
def test_runtime_loader_converts_once_and_shares_the_cache(pyannet, campnet, tmp_path, net):
    """`.onnx` converts and caches a sibling `<file>.jax.npz`, the name the
    JAX package uses, so the JAX loader reads the port's conversion; the
    second load reads the cache."""
    src = (pyannet if net == "segmentation" else campnet)[1]
    onnx = tmp_path / src.name
    onnx.write_bytes(src.read_bytes())
    load = getattr(tcv, f"load_{net}_params")
    params = load(str(onnx), device="cpu")
    cache = onnx.with_name(onnx.name + ".jax.npz")
    assert cache.exists()
    again = load(str(onnx), device="cpu")
    key = ("cls", "w") if net == "segmentation" else ("dense", "w")
    assert torch.equal(params[key[0]][key[1]], again[key[0]][key[1]])
    assert all(t.device.type == "cpu" for t in params[key[0]].values())
    jtree = getattr(jcv, f"load_{net}_params")(str(onnx))
    np.testing.assert_array_equal(np.asarray(jtree["dense" if net == "campplus" else "cls"]["w"]),
                                  np.load(cache)[".".join(key)])


def test_loaders_fail_loudly(tmp_path):
    bogus = tmp_path / "model.onnx"
    bogus.write_bytes(b"not really onnx")
    with pytest.raises(tcv.WeightIngestError):
        tcv.load_segmentation_params(str(bogus), device="cpu")
    with pytest.raises(tcv.WeightIngestError, match="missing"):
        tcv.load_campplus_params(str(tmp_path / "absent.onnx"), device="cpu")
    with pytest.raises(tcv.WeightIngestError, match="unsupported"):
        tcv.load_campplus_params(__file__, device="cpu")
    seg = tcv.load_segmentation_params("__random__", device="cpu")
    ref = segmentation.init_params(0)
    assert torch.equal(seg["lstm"][3]["w_hh"], ref["lstm"][3]["w_hh"])
    emb = tcv.load_campplus_params(str(bogus), allow_random=True, device="cpu")
    assert torch.equal(emb["dense"]["w"], campplus.init_params(0)["dense"]["w"])


def test_engine_diarize_fails_loudly_on_bad_weights(tmp_path):
    """Unloadable diarization weights raise before anything runs, unless
    `allow_random_weights` opts into noise."""
    from whisper_diarize_tpu_torch.engine import Engine, EngineConfig
    from whisper_diarize_tpu_torch.types import Callbacks, TranscribeOptions

    bad = tmp_path / "segmentation-3.0.onnx"
    bad.write_bytes(b"junk")
    kw = dict(cache_dir=str(tmp_path / "cache"), use_gpu=False,
              diarize_segment_model_path=str(bad), diarize_embedding_model_path=str(bad))
    with pytest.raises(tcv.WeightIngestError):
        Engine(EngineConfig(**kw))._resolve_diarization(TranscribeOptions(), Callbacks())
    opts, params = Engine(EngineConfig(allow_random_weights=True, **kw))._resolve_diarization(
        TranscribeOptions(max_speakers=3), Callbacks())
    assert opts.max_speakers == 3 and opts.threshold == 0.5
    assert params["cls"]["w"].device.type == "cpu"
