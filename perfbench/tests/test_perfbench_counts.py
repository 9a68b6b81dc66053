"""The yardstick's FLOP and byte counts against hand counts at both
widths.  Hand counts: yi-9b's layer holds 4096*4096 (q) + 2*4096*512
(k, v) + 4096*4096 (o) + 3*4096*11008 (MLP) = 173,015,040 projection
weights; smollm-360m's 960*960 + 2*960*320 + 960*960 + 3*960*2560 =
9,830,400."""

import pytest

from perfbench import bench
from perfbench.families import dense_gqa as fam

# (config, L, D, H, Hkv, hd, V, layer weights, all weights)
HAND = [("yi-9b", 48, 4096, 32, 4, 128, 64000, 173_015_040, 8_829_407_232),
        ("smollm-360m", 32, 960, 15, 5, 64, 49152, 9_830_400, 409_007_040)]


def conf(name):
    return bench.load_json(bench.PB / "configs" / f"{name}.json")


@pytest.mark.parametrize("row", HAND, ids=[r[0] for r in HAND])
def test_weights_and_kv(row):
    name, L, D, H, Hkv, hd, V, per_layer, total = row
    c = conf(name)
    assert fam.layer_matmul_params(c) == per_layer
    assert fam.param_count(c) == total
    assert fam.kv_bytes_per_token(c) == L * Hkv * hd * 4


@pytest.mark.parametrize("row", HAND, ids=[r[0] for r in HAND])
def test_chunk_and_decode_flops(row):
    name, L, D, H, Hkv, hd, V, per_layer, _ = row
    c = conf(name)
    # 100 rows after a 1,000-token prefix: row i attends 1,001 + i keys
    keys = sum(1001 + i for i in range(100))
    assert keys == 100 * 1000 + 5050
    want = 2 * L * per_layer * 100 + L * 4 * H * hd * keys + 2 * D * V
    assert fam.chunk_flops(c, 1000, 100) == want
    # three rows of lengths 10, 20, 30 attend 11, 21, 31 keys
    want = 3 * (2 * L * per_layer + 2 * D * V) + L * 4 * H * hd * 63
    assert fam.decode_flops(c, [10, 20, 30]) == want
    assert fam.decode_flops(c, []) == 0


@pytest.mark.parametrize("row", HAND, ids=[r[0] for r in HAND])
def test_kernel_bytes(row):
    name, L, D, H, Hkv, hd, V, _, _ = row
    c = conf(name)
    assert fam.rmsnorm_bytes(2048, D) == 2048 * D * 2 * 2 + D * 2
    keys = [5, 17, 1, 1]
    want = 4 * H * hd * 2 * 2 + 24 * Hkv * hd * 2 * 2 + 4 * 400 * 4 + 4 * 4
    assert fam.paged_attention_bytes(c, keys, 400) == want
    assert fam.paged_attention_flops(c, keys) == 4 * H * hd * 24


def test_mfu_and_roofline_readers():
    c = conf("yi-9b")
    peaks = bench.load_json(bench.PB / "peaks.json")["NVIDIA H100 80GB HBM3"]
    steps = [{"name": "chunk_prefill", "t0": 1.0, "t1": 1.5,
              "dispatch_s": 0.1, "execute_s": 0.4,
              "flops": fam.chunk_flops(c, 0, 2048)},
             {"name": "paged_decode_step", "t0": 1.5, "t1": 1.6,
              "dispatch_s": 0.08, "execute_s": 0.02,
              "flops": fam.decode_flops(c, [2048] * 16)},
             {"name": "paged_decode_step", "t0": 9.9, "t1": 10.2,
              "dispatch_s": 0.1, "execute_s": 0.2, "flops": 10**15}]
    ctx = {"w0": 1.0, "w1": 10.0, "window_s": 9.0, "steps": steps,
           "peaks": peaks, "trace": {"kernel_s": {"rmsnorm": 0.002},
                                     "kernel_n": {"rmsnorm": 97}},
           "kernels": {"rmsnorm": {"counted": 97, "bytes": 6.7e6,
                                   "flops": 1e6}}}
    cell = bench.Cell(bench.load_json(bench.ROOT / "BENCHMARK.json"),
                      "smollm.longdoc.backlog")
    mfu = cell.readers["mfu"].read(ctx)
    flops = steps[0]["flops"] + steps[1]["flops"]   # the third ends late
    assert mfu == pytest.approx(100 * flops / (9.0 * 989e12))
    assert cell.readers["host_dispatch_share"].read(ctx) == \
        pytest.approx(100 * 0.18 / 9.0)
    assert cell.readers["chunk_prefill_ms"].read(ctx) == pytest.approx(500)
    # the paged attention's share of its roofline: bytes over HBM peak
    ctx["trace"]["kernel_n"]["paged_decode_attention"] = 48
    ctx["trace"]["kernel_s"]["paged_decode_attention"] = 0.004
    keys = [2049] * 16
    ctx["kernels"]["paged_decode_attention"] = {
        "counted": 48, "bytes": 48 * fam.paged_attention_bytes(c, keys, 400),
        "flops": 48 * fam.paged_attention_flops(c, keys)}
    want = 48 * (2 * 16 * 32 * 128 * 2 + 16 * 2049 * 4 * 128 * 4
                 + 16 * 400 * 4 + 16 * 4) / 3.35e12
    assert cell.readers["paged_decode_attention_roofline"].read(ctx) == \
        pytest.approx(100 * want / 0.004)
    ctx["trace"] = None
    assert cell.readers["paged_decode_attention_roofline"].read(ctx) is None
