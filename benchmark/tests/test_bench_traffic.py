"""The traffic generator and the device-trace reader."""

import numpy as np
import pytest

from benchmark import devtrace, spec, traffic


@pytest.fixture(scope="module")
def tr():
    t = spec.cell("large-v3.beam5.b16")["traffic"]
    return dict(t, files_per_call=6, length_s_min=1.0, length_s_max=3.0)


def test_same_seed_same_audio_other_seed_other_audio(tr):
    a, b, c = traffic.make_audio(tr, 2**31 + 5), traffic.make_audio(tr, 2**31 + 5), \
        traffic.make_audio(tr, 7)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))
    # every seed: the same set of lengths
    assert [len(x) for x in a] == [len(x) for x in c] == traffic.lengths(tr)
    # every seed and call: one order, a permutation of the traffic's order_seed
    order = traffic.call_order(tr)
    assert sorted(order) == list(range(6)) and order != sorted(order)
    orders = {tuple(traffic.call_order(dict(tr, order_seed=k))) for k in range(8)}
    assert len(orders) > 1 and all(sorted(o) == list(range(6)) for o in orders)


def test_lengths_are_the_log_uniform_quantiles():
    t = spec.cell("large-v3.beam5.b16")["traffic"]
    secs = np.array(traffic.lengths(t)) / 16000
    assert len(secs) == 48 and 30 < secs[0] < secs[-1] < 150
    assert np.allclose(np.diff(np.log(secs)), np.log(5) / 48, rtol=1e-4)


def test_suppressed_ids(tr):
    ids = traffic.suppressed_ids(tr, 50257, 50365)
    assert ids[0] == 50257 and ids[1] == 50366 and ids[-1] == 50365 + 1499
    assert 50365 not in ids and 50365 + 1500 not in ids


def _events(layout):
    """Synthetic device events: 'M' markers, anything else a kernel."""
    out, t = [], 0.0
    for name in layout:
        out.append((t, t + 1.0, "void at::spin_kernel()" if name == "M" else name))
        t += 2.0
    return out


def test_trace_reader_splits_by_markers():
    labels = ["begin", "decode>", "decode<", "end", "tail"]
    ev = _events(["fill", "M", "glue", "M", "skinny_gemm", "cross_attn", "M", "x", "M",
                  "fill", "M"])
    r = devtrace.read(ev, labels, 30.0)
    assert [n for _, _, n in r["spans"]["decode"]] == ["skinny_gemm", "cross_attn"]
    assert [n for _, _, n in r["spans"]["glue:decode"]] == ["x"]
    assert r["busy_s"] == pytest.approx(4.0) and r["ops"] == 4
    # the tail's marker lost: still placed; a lost middle marker: refused
    assert devtrace.read(ev[:-1], labels, 30.0) is not None
    assert devtrace.read(ev[:3] + ev[4:], labels, 30.0) is None
