"""The hand-written CUDA kernels on the card (marker `cuda`; skipped where
torch sees no CUDA device). Run on a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda

Each kernel against its plain version in bf16 on the same device, at small
shapes with Dh = 64 and a ragged audio length, with the tolerance of
`whisper_diarize_tpu_torch/kernels/agreement.py` (a few bf16 ulps per
element and 1e-2 relative L2 of the update; K3 is judged on the update it
adds to x), and the planted faults that check must refuse.
"""

import pytest
import torch

from whisper_diarize_tpu_torch.kernels import agreement as ag
from whisper_diarize_tpu_torch.ops import attn, tail

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,Ta,Q", [(2, 100, 3), (3, 1500, 17)])
def test_kernels_match_plain_on_card(dev, B, Ta, Q):
    g = torch.Generator(device=dev).manual_seed(B)
    L, H, Dh = 2, 2, 64
    D = H * Dh
    blocks = ag.random_blocks(L, D, g, dev)
    xa = ag.randn(g, dev, B, Ta, D)
    a = (xa, blocks["ck_w"], blocks["cv_w"], blocks["cv_b"], H)
    before = attn.cross_kv_build.launches
    k, v = attn.cross_kv_build(*a)
    assert attn.cross_kv_build.launches == before + 1
    ag.compare("K2 k", k, attn.cross_kv_build_plain(*a)[0])
    ag.compare("K2 v", v, attn.cross_kv_build_plain(*a)[1])
    for name, i, bad in ag.k2_faults(*a):
        ag.reject(name, (k, v)[i], bad)
    q = ag.randn(g, dev, B, Q, H, Dh, scale=2.0)
    for layer in range(L):
        got = attn.cross_attn_layer(layer, q, k, v, Ta - 7)
        ag.compare("K1", got, attn.cross_attn_layer_plain(layer, q, k, v, Ta - 7))
        for name, bad in ag.k1_faults(layer, q, k, v, Ta - 7):
            ag.reject(name, got, bad)
        for beams in (1, 3):
            x = ag.randn(g, dev, B * beams, 1, D)
            so = ag.randn(g, dev, B * beams, H, 1, Dh, scale=0.3)
            args = (layer, x, so, blocks, k, v, beams, Ta)
            got = tail.fused_tail_layer(*args)
            ag.compare("K3 update", got, tail.fused_tail_layer_plain(*args), base=x)
            for name, bad in ag.k3_faults(*args):
                ag.reject(name, got, bad, base=x)
    torch.cuda.synchronize()


def test_kernel_wrappers_reject_what_they_do_not_take(dev):
    q = torch.zeros(1, 1, 2, 32, dtype=torch.bfloat16, device=dev)  # Dh 32
    k = torch.zeros(1, 1, 2, 10, 32, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        attn.cross_attn_layer(0, q, k, k)
    with pytest.raises(TypeError):
        attn.cross_attn_layer(0, q.float(), k.float(), k.float())
