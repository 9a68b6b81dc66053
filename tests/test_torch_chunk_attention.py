"""The chunked prefill's causal attention off the card (no JAX):

* the tiles the card's kernel walks (``row_tiles``, ``key_tiles``,
  ``attended_cells``) against a brute-force count of the causal cells of
  the real rows, rounded up to whole tiles;
* the plain model of the kernel's tile walk against the formula, and the
  padding rows as zeros;
* the front door on the CPU is the plain version and launches nothing;
* ``layers.attention_apply``'s cached-prefill branch on the CPU keeps the
  values of the formula it had (the prefix and the chunk joined, padded
  to ``kv_len``, repeated for every head, ``full_attention``), bit for
  bit, with the prefix's K/V in what ``kv_out`` returns or not, and with
  the RoPE tables made once for every layer.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.registry import get_arch
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.chunk_attention.ops import chunk_attention
from repro_torch.kernels.chunk_attention.ref import (
    BLOCK_M, BLOCK_N, attended_cells, causal_cells, chunk_attention_ref,
    chunk_attention_tiled_ref, key_tiles, row_tiles)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

PREFIXES = [0, 1, 17, 63, 64, 65, 2047, 6144]
ROWS = [1, 63, 64, 65, 1000, 2048]


def _brute_tiles(prefix: int, n_rows: int) -> list[int]:
    """For each row tile holding a real row, the key tiles holding a key a
    real row of it attends to, counted from the causal mask itself."""
    keys = prefix + n_rows
    mask = (np.arange(keys)[None, :]
            <= prefix + np.arange(n_rows)[:, None])       # (rows, keys)
    out = []
    for i in range(0, n_rows, BLOCK_M):
        cols = mask[i:i + BLOCK_M].any(axis=0)
        tiles = {j // BLOCK_N for j in np.flatnonzero(cols)}
        assert tiles == set(range(len(tiles)))    # from key 0, no gap
        out.append(len(tiles))
    return out


@pytest.mark.parametrize("n_rows", ROWS)
@pytest.mark.parametrize("prefix", PREFIXES)
def test_tiles_against_a_brute_force_count(prefix, n_rows):
    walked = _brute_tiles(prefix, n_rows)
    assert row_tiles(n_rows) == len(walked)
    assert [key_tiles(prefix, n_rows, i)
            for i in range(row_tiles(n_rows))] == walked
    assert attended_cells(prefix, n_rows) == \
        BLOCK_M * BLOCK_N * sum(walked)
    # every causal cell of a real row lies in a walked tile
    assert causal_cells(prefix, n_rows) == \
        sum(prefix + r + 1 for r in range(n_rows)) <= \
        attended_cells(prefix, n_rows)


def test_skipped_share_at_the_served_shape():
    """The unit runner's launch: 2,048 rows x 8,448 keys; a typical chunk
    of 1,000 real rows after a 1,900-token prefix walks 14.6% of it."""
    launched = 2048 * 8448
    assert attended_cells(1900, 1000) == 2_523_136
    assert 0.85 < 1 - attended_cells(1900, 1000) / launched < 0.86
    assert attended_cells(0, 2048) < launched


def _inputs(b, s, p, h, hkv, hd, seed):
    g = torch.Generator().manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=g).to(torch.bfloat16)
    return (draw(b, s, h, hd), draw(b, p, hkv, hd), draw(b, p, hkv, hd),
            draw(b, s, hkv, hd), draw(b, s, hkv, hd))


@pytest.mark.parametrize("b,s,p,h,hkv,hd,n_rows", [
    (1, 100, 0, 6, 2, 32, 100), (2, 130, 70, 4, 4, 64, 65),
    (1, 64, 129, 3, 1, 32, 1), (2, 17, 200, 4, 2, 32, 17),
    (1, 200, 63, 4, 2, 32, 129)])
def test_tiled_model_against_the_formula(b, s, p, h, hkv, hd, n_rows):
    """The tile walk gives the formula, the probabilities' bf16 rounding
    aside (2^-8 of the largest |v|, and one bf16 rounding of the output);
    padding rows are zeros in both."""
    args = _inputs(b, s, p, h, hkv, hd, seed=s + p)
    want = chunk_attention_ref(*args, n_rows).float()
    got = chunk_attention_tiled_ref(*args, n_rows).float()
    vmax = float(torch.cat([args[2], args[4][:, :n_rows]], 1).abs().max())
    torch.testing.assert_close(got, want, atol=2.0 ** -8 * vmax,
                               rtol=2.0 ** -7)
    assert not want[:, n_rows:].any() and not got[:, n_rows:].any()


def test_formula_is_full_attention_over_the_joined_keys():
    b, s, p, h, hkv, hd, n = 2, 40, 30, 6, 2, 32, 33
    q, pk, pv, k, v = _inputs(b, s, p, h, hkv, hd, seed=1)
    kk = L._repeat_kv(torch.cat([pk, k], 1).float(), h // hkv)
    vv = L._repeat_kv(torch.cat([pv, v], 1).float(), h // hkv)
    want = L.full_attention(q.float(), kk, vv, causal=True, q_offset=p)
    got = chunk_attention_ref(q, pk, pv, k, v, n)
    # the same f32 values up to the order of their sums, rounded to bf16
    torch.testing.assert_close(got[:, :n].float(),
                               want[:, :n].to(torch.bfloat16).float(),
                               atol=1e-5, rtol=2.0 ** -7)


def test_front_door_on_the_cpu_is_the_plain_version():
    args = _inputs(1, 20, 9, 4, 2, 32, seed=2)
    reset_launch_counts()
    assert torch.equal(chunk_attention(*args, 11),
                       chunk_attention_ref(*args, 11))
    assert launch_counts()["chunk_attention"] == 0


def _old_prefix_branch(lp, x, cfg, pk, pv, q_offset, kv_len):
    """The cached-prefill branch as it was written before the card's
    kernel: (out, full-context k, v)."""
    b, s, _ = x.shape
    hd, h, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    positions = torch.arange(s)[None, :] + q_offset
    q = L.apply_rope(L.dense(lp["wq"], x).reshape(b, s, h, hd), positions,
                     cfg.rope_theta)
    k = L.apply_rope(L.dense(lp["wk"], x).reshape(b, s, hkv, hd), positions,
                     cfg.rope_theta)
    v = L.dense(lp["wv"], x).reshape(b, s, hkv, hd)
    k, v = torch.cat([pk, k], dim=1), torch.cat([pv, v], dim=1)
    ka, va = k, v
    if kv_len is not None and kv_len > k.shape[1]:
        pad = (0, 0, 0, 0, 0, kv_len - k.shape[1])
        ka, va = F.pad(k, pad), F.pad(v, pad)
    out = L.full_attention(q, L._repeat_kv(ka, h // hkv),
                           L._repeat_kv(va, h // hkv), causal=True,
                           q_offset=q_offset)
    return L.dense(lp["wo"], out.reshape(b, s, h * hd)), k, v


@pytest.mark.parametrize("kv_len", [None, 64])
def test_cpu_prefix_branch_keeps_its_values(kv_len):
    cfg = get_arch("smollm-360m").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lp = T.layer_params(params, 1)["attn"]
    g = torch.Generator().manual_seed(3)
    b, s, p = 2, 9, 11
    x = torch.randn((b, s, cfg.d_model), generator=g).to(torch.bfloat16)
    shape = (b, p, cfg.n_kv_heads, cfg.resolved_head_dim)
    pk = torch.randn(shape, generator=g).to(torch.bfloat16)
    pv = torch.randn(shape, generator=g).to(torch.bfloat16)
    want, wk, wv = _old_prefix_branch(lp, x, cfg, pk, pv, p, kv_len)
    out, (k, v) = L.attention_apply(lp, x, cfg, kv_out=True,
                                    prefix_kv=(pk, pv), q_offset=p,
                                    kv_len=kv_len, n_rows=5)
    assert torch.equal(out, want)
    assert torch.equal(k, wk[:, p:]) and torch.equal(v, wv[:, p:])
    out, (k, v) = L.attention_apply(lp, x, cfg, kv_out=True,
                                    prefix_kv=(pk, pv), q_offset=p,
                                    kv_len=kv_len)
    assert torch.equal(out, want)
    assert torch.equal(k, wk[:, p:]) and torch.equal(v, wv[:, p:])
    # the RoPE tables made once for every layer of a step
    positions = torch.arange(s)[None, :] + p
    rope = L.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    out, _ = L.attention_apply(lp, x, cfg, positions=positions,
                               prefix_kv=(pk, pv), q_offset=p,
                               kv_len=kv_len, rope=rope)
    assert torch.equal(out, want)
