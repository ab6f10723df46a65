"""The yardstick's arithmetic: the union of device intervals, gaps,
percentiles, whole-window rates, spreads, the kernels' least times and
the readers built on them."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import arith, manifest
from benchmark.arith import feature_hw
from benchmark.drivers import Window
from benchmark.timeline import Timeline, group


def test_union_is_not_a_sum():
    # two overlapping kernels and a third apart: 3 + 1, not 2 + 2 + 1
    assert arith.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert arith.union_seconds([(0, 1), (0, 1)]) == 1
    assert arith.union_seconds([(0, 4), (1, 2)]) == 4
    assert arith.union_seconds([]) == 0


def test_gaps():
    assert arith.gaps([(1, 2), (3, 4)], 0, 5) == [(0, 1), (2, 3), (4, 5)]
    assert arith.gaps([(0, 5)], 0, 5) == []


def test_percentile_and_rate():
    xs = list(range(1, 101))
    assert arith.percentile(xs, 50) == 50.5
    assert arith.percentile(xs, 95) == pytest.approx(95.05)
    assert arith.percentile([7.0], 95) == 7.0
    assert arith.rate(320, 2.0) == 160
    with pytest.raises(ValueError):
        arith.rate(1, 0)


def test_bounds_follow_the_larger_term():
    # 3.35e9 bytes take 1 ms at HBM rate; 67e9 flops take 1 ms at fp32
    assert arith.bound_ms(3.35e9, 0) == pytest.approx(1.0)
    assert arith.bound_ms(0, 67e9) == pytest.approx(1.0)
    assert arith.bound_ms(3.35e9, 134e9) == pytest.approx(2.0)
    # min-plus: one add and one min a term at half the fp32 rate
    z, m, k, n = 4, 401, 401, 401
    ops = 2 * z * m * n * k
    assert arith.minplus_bound(1, z, m, k, n) == pytest.approx(
        max(4 * (m * k + z * k * n + z * m * n) / 3.35e12,
            ops / 33.5e12) * 1e3)


def test_mpm_work_counts_each_byte_once():
    b, s, q, n, c, p = 4, 1, 1, 2601, 512, 3
    w = arith.mpm_work(b, s, q, n, c, p, 2)
    assert w["assign"][0] == (b * s * n * c * 2 + 2 * b * s * n * 4
                              + c * 2 * p * 4 + b * 2 * p * c * 4)
    assert w["match"][0] == b * q * n * c * 2 + b * 2 * p * c * 4 \
        + b * q * n * 2 * 4


def test_feature_size():
    assert feature_hw({"data": {"height": 401, "width": 401}}) == (51, 51)
    assert feature_hw({"data": {"height": 33, "width": 65}}) == (5, 9)


def test_groups():
    assert group("sm90_xmma_fprop_implicit_gemm_bf16") == "conv"
    assert group("void assign_kernel<3>") == "kernels"
    assert group("Memcpy DtoD (Device -> Device)") == "copy"
    assert group("batch_norm_transform_input_channels_last_kernel") \
        == "fusion"


def _ctx(**kw):
    cfg = manifest.cell("pemp-s1-r50.train-b4-fuse8").config
    mix = {"mode": "train", "batch": 4, "fuse_steps": 8}
    base = dict(config=cfg, mix=mix, trace=None, flops_per_call=None,
                device_name="NVIDIA H100 80GB HBM3", setup_s=30.0,
                window=Window(calls=10, episodes=320, seconds=2.0,
                              call_s=[0.2] * 10))
    base.update(kw)
    return SimpleNamespace(**base)


def test_end_to_end_readers():
    ctx = _ctx()
    assert manifest.reader("train_episodes_per_s")(ctx) == 160
    assert manifest.reader("setup_s")(ctx) == 30.0
    ctx.window.call_s = [0.01 * i for i in range(1, 101)]
    assert manifest.reader("episode_latency_p95_ms")(ctx) == \
        pytest.approx(950.5)


def test_idle_share_from_the_union():
    tl = Timeline(0.0, 1.0, device=[("k1", 0.0, 0.5), ("k2", 0.25, 0.75)])
    ctx = _ctx(trace={"timeline": tl, "steps": 8})
    # busy 0.75 of 1 s (the sum of kernel times would say 1.0, idle 0)
    assert manifest.reader("device_idle_share.train")(ctx) == \
        pytest.approx(25.0)


def test_mfu_and_none_without_a_peak():
    ctx = _ctx(flops_per_call=8 * 1.5e12)
    got = manifest.reader("mfu.train")(ctx)
    assert got == pytest.approx(100 * 8 * 1.5e12 * 10 / 2.0 / 989.4e12)
    ctx.device_name = "cpu"
    assert manifest.reader("mfu.train")(ctx) is None


def test_roofline_reader():
    cfg = manifest.cell("pemp-s1-r50.train-b4-fuse8").config
    w = arith.mpm_work(4, 1, 1, 51 * 51, 512, 3, 2)
    bound = arith.bound_ms(*w["assign"]) * 1e-3
    # one K1 launch that took twice its least time: 50 %
    tl = Timeline(0.0, 1.0, device=[("assign_kernel<3>", 0.1,
                                     0.1 + 2 * bound)])
    ctx = _ctx(trace={"timeline": tl, "steps": 8}, config=cfg)
    assert manifest.reader("kernels_roofline.train")(ctx) == \
        pytest.approx(50.0)
    ctx.trace = {"timeline": Timeline(0.0, 1.0), "steps": 8}
    assert manifest.reader("kernels_roofline.train")(ctx) is None


def test_idle_gaps_by_innermost_host_event():
    tl = Timeline(0.0, 10.0, device=[("k", 0.0, 2.0), ("k", 6.0, 10.0)],
                  host=[("outer", 0.0, 10.0), ("sync", 2.5, 3.5),
                        ("launch", 4.0, 5.5)])
    # gaps: (2, 6), middle 4 -> "launch" is the innermost live event
    assert tl.idle_gaps() == [["launch", 4.0]]
    tl.host = [("outer", 0.0, 10.0), ("sync", 3.0, 4.5)]
    assert tl.idle_gaps() == [["sync", 4.0]]
    tl.host = []
    assert tl.idle_gaps() == [["(no host event)", 4.0]]
