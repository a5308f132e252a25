"""The trace arithmetic and the per-layer readers on made-up records."""

import pytest

from benchmark import layers, trace
from benchmark.drivers.common import Layers


def test_union_of_overlapping_intervals():
    assert trace.union_us([]) == 0.0
    assert trace.union_us([(0, 10), (5, 15), (20, 30)]) == 25.0
    assert trace.union_us([(0, 10), (2, 3), (10, 12)]) == 12.0
    assert trace.union_us([(5, 6), (0, 100)]) == 100.0


def _trace():
    kernels = [("void sparse_conv_mma<64>(...)", 0.0, 10.0), ("ordered_sum_kernel", 10.0, 12.0),
               ("elementwise", 30.0, 40.0), ("void sparse_conv_mma<64>(...)", 60.0, 70.0)]
    phases = [("backbone_heads", 0.0, 20.0), ("report", 20.0, 45.0), ("merge", 45.0, 80.0)]
    busy = trace.union_us([(s, e) for _, s, e in kernels]) / 1e6
    return trace.Trace(100e-6, busy, kernels, phases, (-5.0, 95.0))


def test_trace_breakdown():
    tr = _trace()
    assert tr.busy_s == pytest.approx(32e-6)
    ops = dict(tr.device_ops())
    assert ops["void sparse_conv_mma<64>(...)"] == pytest.approx(20e-6)
    gaps = dict(tr.idle_gaps())
    # the gaps before the first kernel (-5..0) and after the last (70..95)
    assert gaps == pytest.approx({"outside": 30e-6, "report": 18e-6, "merge": 20e-6})
    assert tr.family_in_phase("A", "backbone_heads") == pytest.approx(10e-6)
    assert tr.family_in_phase("A, D second pass", "backbone_heads") == pytest.approx(2e-6)
    assert trace.family("void meanshift_converge_kernel<5>") == "C"


def test_readers():
    lay = Layers(units=4, phases={"collate": 0.02, "backbone_heads": 0.4},
                 window_s=2.0, model_ops=989e12 * 2.0 * 0.01, trace=_trace(), trace_units=2,
                 conv_bound_s=6e-6, plain_unit_s=50e-6)
    assert layers.per_unit(lay, "collate", scale=1e3) == pytest.approx(5.0)
    assert layers.per_unit(lay, "region_growing") is None
    assert layers.mfu(lay) == pytest.approx(1.0)
    # 32 us busy over two profiled units, against 50 us a plain unit
    assert layers.idle_share(lay) == pytest.approx(68.0)
    assert layers.conv_roofline(lay) == pytest.approx(50.0)
    empty = Layers()
    for f in (layers.mfu, layers.idle_share, layers.conv_roofline):
        assert f(empty) is None
