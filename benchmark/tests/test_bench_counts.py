"""The yardstick's arithmetic against hand counts at large-v3's shapes
(d 1280, 32 + 32 layers, 1,500 positions, 128 mels, 51,866 tokens)."""

import json
import os

import pytest

from benchmark import counts, spec


@pytest.fixture(scope="module")
def v3():
    return spec.load_json(os.path.join(spec.HERE, "configs", "large-v3.json"))


def test_peaks_and_least_time():
    assert counts.HBM_BYTES_PER_S == 3.35e12 and counts.BF16_FLOPS == 989e12
    assert counts.least_s(3.35e12, 0) == pytest.approx(1.0)
    assert counts.least_s(0, 989e12) == pytest.approx(1.0)
    assert counts.union_s([(0, 2), (1, 3), (5, 6)]) == pytest.approx(4.0)


def test_tail_gemm_work_by_hand(v3):
    # 80 rows (16 streams x 5 beams): per layer the weights 11 d^2 bf16,
    # the products' inputs (80 x (d + d + d + d + 4d)) and outputs
    # (80 x (d + d + d + 4d + d)), 2 x 80 x 11 d^2 operations
    d, rows = 1280, 80
    by_hand_bytes = 32 * 2 * (11 * d * d + rows * 8 * d + rows * 8 * d)
    nbytes, flops = counts.tail_gemm_work(v3, rows)
    assert nbytes == by_hand_bytes == 1_258_291_200
    assert flops == 32 * 2 * rows * 11 * d * d
    # the least time is the weights' stream: ~0.35 ms a step
    assert counts.least_s(nbytes, flops) == pytest.approx(by_hand_bytes / 3.35e12)


def test_cross_attn_work_by_hand(v3):
    # 16 streams, 5 queries: every layer's K and V [16, 1500, 1280] bf16
    nbytes, flops = counts.cross_attn_work(v3, 16, 5)
    assert nbytes == 32 * 2 * (2 * 16 * 5 * 1280 + 2 * 16 * 1500 * 1280)
    assert flops == 32 * 4 * 16 * 5 * 1500 * 1280


def test_encoder_and_window_flops_by_hand(v3):
    d, t = 1280, 1500
    stem = 2 * 128 * d * 3 * 3000 + 2 * d * d * 3 * t
    layer = 2 * t * 12 * d * d + 4 * t * t * d
    assert counts.encoder_flops(v3) == stem + 32 * layer
    assert counts.encoder_flops(v3) == pytest.approx(2.27e12, rel=0.01)
    assert counts.cross_kv_flops(v3) == 32 * 2 * t * 2 * d * d
    # one decode step of one row at key count 10: 14 d^2 products, cross and
    # self attention, the logits
    step = counts.decode_flops(v3, 9, 1, 1)
    assert step == 32 * (2 * 14 * d * d + 4 * t * d + 4 * 10 * d) + 2 * d * 51866
    total = counts.window_flops(v3, 3, 2, 64, 5, 0)
    assert total == (counts.encoder_flops(v3) + counts.cross_kv_flops(v3)
                     + counts.prompt_flops(v3, 3, 2) + counts.decode_flops(v3, 3, 64, 5))


def test_traffic_files_state_their_handling():
    for name in os.listdir(os.path.join(spec.HERE, "traffic")):
        tr = json.load(open(os.path.join(spec.HERE, "traffic", name)))
        h = tr["handling"]
        assert h["suppress"] == ["eot", "mid_timestamps"] and h["fallback_ladder"] is False
        assert tr["diarize"] == bool(h.get("one_turn_per_file"))
