"""The port's ``parallel/`` and ``launch/{mesh,specs}`` against the JAX
package's, on the CPU.

* Sharding specs: for each of the ten archs, fsdp on and off, with no
  mesh, a (data 2, model 4) and a (pod 2, data 4, model 2) mesh, the
  port's ``param_specs``, ``opt_state_specs`` (adamw and adafactor),
  ``batch_specs`` and ``cache_specs`` equal ``tuple(spec)`` of JAX's, leaf
  by leaf.  JAX's rules read only ``mesh.shape`` and ``mesh.axis_names``,
  so a stub mesh serves both packages in-process.
* ``to_placements`` shards data in JAX's major-to-minor order: every
  rank's shard on a fake (2, 2, 2) mesh equals the numpy slice JAX's
  ``NamedSharding`` gives that device.
* ``count_params`` / ``active_params``, and the shape and dtype of every
  parameter and input stand-in (``launch/specs.py``), equal JAX's for
  every arch; the production meshes have JAX's axes and sizes (on the
  fake backend).
* The activation context: off, the port's models give the bits they give
  with every helper replaced by its plain op; on, over a fake mesh, each
  ``shard_*`` helper gives the placements JAX's rule names.
* Compression and pipeline: the port under ``gloo`` at world size 1
  (in-process) and at 4 (``torch.multiprocessing.spawn``, a ``FileStore``
  in ``tmp_path``) against JAX's ``compressed_psum_grads`` (two steps,
  the second carrying the first's residual) and ``pipeline_apply`` on an
  8-device host mesh (a subprocess, as ``tests/test_parallel.py`` runs
  them): 1e-6 and 1e-5; the error feedback's 32-step drift stays under
  5e-3.  Different gradients per rank equal a numpy evaluation of JAX's
  formula.
* Elastic restore: a checkpoint saved under a (4, 2) mesh restores under
  a (2, 2) one bit for bit, in the same ``gloo`` world (8 ranks).
* ``ctx.per_shard_rows``: in the same world, the sLSTM and mLSTM blocks
  (per token and chunked) with the batch sharded over 'data' run their
  scans on each rank's rows; outputs and the gradients of the input and
  every weight (the sLSTM's recurrent ``r`` summed over the ranks' rows)
  equal the plain blocks on the whole batch within 1e-5; the outputs keep
  the input's batch shard.
"""

import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import torch_dist_worker as W
from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.configs.registry import get_shape as jax_get_shape
from repro.launch import specs as JS
from repro.optim.optimizers import OptConfig as JaxOptConfig
from repro.optim.optimizers import opt_init as jax_opt_init
from repro.parallel import ctx as JCTX
from repro.parallel import sharding as JSH
from repro_torch.configs.registry import ARCHS, get_arch, get_shape
from repro_torch.launch import specs as S
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import OptConfig, opt_init
from repro_torch.parallel import compression, pipeline
from repro_torch.parallel import ctx as pctx
from repro_torch.parallel import sharding as SH

ROOT = Path(__file__).resolve().parents[1]
MESHES = {
    "none": None,
    "data2_model4": SimpleNamespace(axis_names=("data", "model"),
                                    shape={"data": 2, "model": 4}),
    "pod2_data4_model2": SimpleNamespace(
        axis_names=("pod", "data", "model"),
        shape={"pod": 2, "data": 4, "model": 2}),
}
COMP_ATOL = 1e-6
PIPE_ATOL = 1e-5


def _jax_flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {tuple(str(k.key) for k in path): tuple(spec)
            for path, spec in leaves}


def _port_flat(tree) -> dict:
    out = {}
    SH.map_with_path(lambda path, spec: out.__setitem__(path, spec), tree)
    return out


_ABSTRACT: dict = {}


def _abstract(name: str) -> dict:
    """Both packages' parameter, optimizer-state, input and cache shapes
    for one arch at full width (computed once a worker)."""
    if name not in _ABSTRACT:
        jcfg, cfg = JAX_ARCHS[name], ARCHS[name]
        jp, pp = JS.param_shapes(jcfg), S.param_shapes(cfg)
        ab = {"params": (jp, pp)}
        for opt in ("adamw", "adafactor"):
            ab[opt] = (jax.eval_shape(
                lambda p, o=opt: jax_opt_init(JaxOptConfig(name=o), p), jp),
                opt_init(OptConfig(name=opt), pp))
        ab["train"] = (JS.train_input_specs(jcfg, jax_get_shape("train_4k")),
                       S.train_input_specs(cfg, get_shape("train_4k")))
        ab["prefill"] = (
            JS.prefill_input_specs(jcfg, jax_get_shape("prefill_32k")),
            S.prefill_input_specs(cfg, get_shape("prefill_32k")))
        for sh in ("decode_32k", "long_500k"):
            ab[sh] = (JS.decode_input_specs(jcfg, jax_get_shape(sh)),
                      S.decode_input_specs(cfg, get_shape(sh)))
        _ABSTRACT[name] = ab
    return _ABSTRACT[name]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_jax(arch, mesh_name):
    mesh = MESHES[mesh_name]
    ab = _abstract(arch)
    jp, pp = ab["params"]
    n = 0
    for fsdp in (False, True):
        jspec = JSH.param_specs(jp, fsdp=fsdp, mesh=mesh)
        pspec = SH.param_specs(pp, fsdp=fsdp, mesh=mesh)
        pairs = [(jspec, pspec)]
        for opt in ("adamw", "adafactor"):
            jo, po = ab[opt]
            pairs.append((JSH.opt_state_specs(jo, jspec),
                          SH.opt_state_specs(po, pspec)))
        if mesh is not None:
            for kind in ("train", "prefill"):
                jb, pb = ab[kind]
                pairs.append((JSH.batch_specs(jb, mesh),
                              SH.batch_specs(pb, mesh)))
            for sh in ("decode_32k", "long_500k"):
                (jc, jt), (pc, pt) = ab[sh]
                b = get_shape(sh).global_batch
                pairs.append((JSH.cache_specs(jc, mesh, b),
                              SH.cache_specs(pc, mesh, b)))
                pairs.append((JSH.batch_specs({"tokens": jt}, mesh),
                              SH.batch_specs({"tokens": pt}, mesh)))
        for want, got in pairs:
            want, got = _jax_flat(want), _port_flat(got)
            assert got == want
            n += len(got)
    assert n > 0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_equal_jax(arch):
    jp, pp = _abstract(arch)["params"]
    total = S.count_params(pp)
    assert total == JS.count_params(jp)
    assert S.active_params(ARCHS[arch], total) \
        == JS.active_params(JAX_ARCHS[arch], total)


def _sds(tree) -> dict:
    """(shape, dtype name) of every leaf, by path, in either package."""
    if isinstance(tree, dict):
        return {(k,) + p: v for k, sub in tree.items()
                for p, v in _sds(sub).items()}
    return {(): (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_equal_jax(arch):
    ab = _abstract(arch)
    for kind in ("train", "prefill"):
        jb, pb = ab[kind]
        assert _sds(pb) == _sds(jb)
    for sh in ("decode_32k", "long_500k"):
        (jc, jt), (pc, pt) = ab[sh]
        assert _sds(pc) == _sds(jc)
        assert _sds(pt) == _sds(jt)
    jp, pp = ab["params"]
    assert _sds(pp) == _sds(jp)


@pytest.fixture
def fake_world():
    """``start(world, rank)``: the fake backend as that rank; the group
    and the activation context are torn down after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(world: int, rank: int = 0):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
    yield start
    pctx.disable()
    if dist.is_initialized():
        dist.destroy_process_group()


def _jax_block(shape: tuple, spec: tuple, sizes: dict, coords: dict):
    """The numpy slice JAX's ``NamedSharding`` gives the device at
    ``coords``: a dim named by several axes is split major to minor."""
    idx = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        block, parts = 0, 1
        for a in axes:
            block, parts = block * sizes[a] + coords[a], parts * sizes[a]
        step = n // parts
        idx.append(slice(block * step, (block + 1) * step))
    return tuple(idx)


@pytest.mark.parametrize("spec,shape", [
    ((("pod", "data"), "model"), (8, 4)),
    ((None, None, ("data", "model"), None, None), (2, 3, 8, 2, 2)),
    ((None, ("pod", "data"), "model", None, None), (2, 4, 6, 2, 2)),
])
def test_to_placements_shards_in_jax_order(fake_world, spec, shape):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    sizes = {"pod": 2, "data": 2, "model": 2}
    arr = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    for rank in range(8):
        fake_world(8, rank)
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        dt = distribute_tensor(torch.from_numpy(arr), mesh,
                               SH.to_placements(spec, mesh),
                               src_data_rank=None)
        want = arr[_jax_block(shape, spec, sizes, coords)]
        np.testing.assert_array_equal(dt.to_local().numpy(), want)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_axes(fake_world, multi_pod):
    from repro_torch.launch.mesh import make_production_mesh
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    if multi_pod:
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.mesh.shape) == (2, 16, 16) and mesh.size() == 512
    else:
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.mesh.shape) == (16, 16) and mesh.size() == 256


def test_to_placements_refuses_axes_out_of_mesh_order(fake_world):
    from torch.distributed.device_mesh import init_device_mesh
    fake_world(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    with pytest.raises(ValueError, match="order"):
        SH.to_placements((("model", "data"),), mesh)


# ---------------------------------------------------------------------------
# the activation context
# ---------------------------------------------------------------------------

_PLAIN = {
    "shard_batch_seq": lambda x: x, "shard_hidden": lambda x: x,
    "shard_heads": lambda x: x, "shard_ffn": lambda x: x,
    "shard_experts": lambda x: x, "shard_bh": lambda x: x,
    "shard_logits": lambda x: x, "reshape": lambda x, s: x.reshape(s),
    "place_cache": lambda c, b: c,
}


def _smollm_outputs(seed: int = 0):
    """Logits of a prefill and two decode steps, and the loss and every
    gradient, of a reduced smollm on the CPU."""
    cfg = get_arch("smollm-360m").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)))
    logits, cache = T.prefill_fn(cfg)(params, {"tokens": toks}, 16)
    outs = [logits]
    step = T.decode_fn(cfg)
    for _ in range(2):
        logits, cache = step(params, cache, logits.argmax(-1))
        outs.append(logits)
    leaves = []
    SH.map_with_path(lambda _, t: leaves.append(t.requires_grad_()), params)
    loss = T.loss_fn(cfg)(params, {"tokens": toks, "labels": toks})
    loss.backward()
    return [o.detach() for o in outs] + [loss.detach()] + \
        [t.grad for t in leaves]


def test_context_off_is_the_plain_model(monkeypatch, fake_world):
    base = _smollm_outputs()
    # a configure/disable cycle leaves nothing behind
    from torch.distributed.device_mesh import init_device_mesh
    fake_world(4)
    pctx.configure(init_device_mesh("cpu", (2, 2),
                                    mesh_dim_names=("data", "model")))
    pctx.disable()
    again = _smollm_outputs()
    for name, fn in _PLAIN.items():
        monkeypatch.setattr(pctx, name, fn)

    def write_rows(cache, rows, pos, value):
        cache[rows, pos] = value

    def write_prefix(dst, src, dim=1):
        dst[(slice(None),) * dim + (slice(0, src.shape[dim]),)] = src
    monkeypatch.setattr(pctx, "write_rows", write_rows)
    monkeypatch.setattr(pctx, "write_prefix", write_prefix)
    monkeypatch.setattr(pctx, "gather_vocab",
                        lambda lg, i: torch.gather(lg, -1, i))
    plain = _smollm_outputs()
    assert len(base) == len(plain) == len(again)
    for a, b, c in zip(base, again, plain):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("helper,shape", [
    ("shard_batch_seq", (4, 6, 8)), ("shard_batch_seq", (3, 6, 8)),
    ("shard_hidden", (4, 6, 8)), ("shard_heads", (4, 6, 8, 16)),
    ("shard_heads", (3, 6, 5, 16)), ("shard_ffn", (4, 6, 16)),
    ("shard_experts", (8, 3, 5, 4)), ("shard_bh", (4, 8, 5)),
    ("shard_bh", (4, 8, 5, 6)), ("shard_logits", (4, 6, 32)),
])
def test_context_helpers_place_as_jax_names(monkeypatch, fake_world,
                                            helper, shape):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    stub = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 2, "model": 4})
    monkeypatch.setattr(JCTX, "_wsc", lambda x, spec: tuple(spec))
    JCTX.configure(stub)
    try:
        spec = getattr(JCTX, helper)(np.zeros(shape, np.float32))
    finally:
        JCTX.disable()
    fake_world(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    pctx.configure(mesh)
    x = DTensor.from_local(torch.zeros(shape), mesh,
                           [Replicate(), Replicate()], run_check=False)
    got = getattr(pctx, helper)(x)
    assert tuple(got.placements) == SH.to_placements(spec, mesh)
    # a plain tensor (a constant the model made) counts as replicated
    assert tuple(getattr(pctx, helper)(torch.zeros(shape)).placements) \
        == SH.to_placements(spec, mesh)


# ---------------------------------------------------------------------------
# compression, pipeline, elastic restore: JAX on 8 host devices, the port
# under gloo
# ---------------------------------------------------------------------------

_JAX_CODE = """
import sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, {tests!r})
import torch_dist_worker as W
from repro.parallel.compression import compressed_psum_grads
from repro.parallel.pipeline import pipeline_apply, bubble_fraction
mesh = jax.make_mesh((8,), ("data",))
g = {{k: jnp.asarray(v) for k, v in W.replicated_grads().items()}}
r = jax.tree.map(jnp.zeros_like, g)
mean, res = compressed_psum_grads(g, r, mesh, "data")
mean2, _ = compressed_psum_grads(g, res, mesh, "data")
ws, xs = W.pipeline_inputs()
got = pipeline_apply(lambda w, x: jnp.tanh(x @ w), jnp.asarray(ws),
                     jnp.asarray(xs), jax.make_mesh((4,), ("stage",)),
                     "stage")
np.savez({out!r}, **{{"mean_" + k: np.asarray(v) for k, v in mean.items()}},
         **{{"res_" + k: np.asarray(v) for k, v in res.items()}},
         **{{"mean2_" + k: np.asarray(v) for k, v in mean2.items()}},
         pipeline=np.asarray(got), bubble=bubble_fraction(4, 6))
"""


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "jax.npz"
    # eight host devices: JAX on the CPU even where it could see a GPU
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_JAX_CODE).format(
            tests=str(ROOT / "tests"), out=str(out))],
        capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    """Every rank's results from one 8-rank ``gloo`` world (spawned)."""
    import torch.multiprocessing as mp
    root = tmp_path_factory.mktemp("gloo")
    ctx = mp.spawn(W.run, args=(8, str(root), str(root)), nprocs=8,
                   join=False)
    deadline = time.monotonic() + 600
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the gloo world did not finish in 600 s")
    return [dict(np.load(root / f"rank{r}.npz")) for r in range(4)]


@pytest.fixture
def gloo_world_1(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _quant(g):
    """JAX's ``_quantize`` then ``_dequantize`` in numpy f32."""
    scale = np.float32(np.abs(g).max()) / np.float32(127.0) \
        + np.float32(1e-30)
    q = np.clip(np.round(g / scale), -127, 127).astype(np.int8)
    return q, np.float32(scale)


def test_compression_world_1_equals_jax(gloo_world_1, jax_results):
    g = {k: torch.from_numpy(v) for k, v in W.replicated_grads().items()}
    r = {k: torch.zeros_like(v) for k, v in g.items()}
    mean, res = compression.compressed_psum_grads(g, r)
    for k in g:
        np.testing.assert_allclose(mean[k].numpy(), jax_results["mean_" + k],
                                   atol=COMP_ATOL, rtol=0)
        np.testing.assert_allclose(res[k].numpy(), jax_results["res_" + k],
                                   atol=COMP_ATOL, rtol=0)
        # world size 1: the mean is dequantize(quantize(g + r)) exactly
        q, scale = _quant(g[k].numpy())
        assert np.array_equal(mean[k].numpy(), q.astype(np.float32) * scale)
        assert np.array_equal(res[k].numpy(), g[k].numpy() - mean[k].numpy())
    # the second step carries the first's residual, as JAX's does
    mean2, _ = compression.compressed_psum_grads(g, res)
    for k in g:
        np.testing.assert_allclose(mean2[k].numpy(), jax_results["mean2_" + k],
                                   atol=COMP_ATOL, rtol=0)
    # error feedback: the bias cancels over 32 steps
    total = {k: torch.zeros_like(v) for k, v in g.items()}
    r = {k: torch.zeros_like(v) for k, v in g.items()}
    for _ in range(32):
        m, r = compression.compressed_psum_grads(g, r)
        total = {k: total[k] + m[k] for k in g}
    for k in g:
        assert np.abs(total[k].numpy() / 32 - g[k].numpy()).max() < 5e-3
    assert compression.compression_ratio() == 4.0


def test_compression_world_4_equals_jax(gloo_results, jax_results):
    for rank in range(4):
        res = gloo_results[rank]
        for k in ("w", "b"):
            np.testing.assert_allclose(res["rep_mean_" + k],
                                       jax_results["mean_" + k],
                                       atol=COMP_ATOL, rtol=0)
            np.testing.assert_allclose(res["rep_res_" + k],
                                       jax_results["res_" + k],
                                       atol=COMP_ATOL, rtol=0)


def test_compression_world_4_different_grads_equal_numpy(gloo_results):
    qs = [_quant(W.rank_grads(r)["w"]) for r in range(4)]
    total = sum(q.astype(np.int32) for q, _ in qs).astype(np.float32)
    scale_sum = np.float32(0)
    for _, s in qs:
        scale_sum = np.float32(scale_sum + s)
    want = total * (scale_sum / np.float32(4)) / np.float32(4)
    for rank in range(4):
        np.testing.assert_allclose(gloo_results[rank]["diff_mean_w"], want,
                                   atol=COMP_ATOL, rtol=1e-6)


def test_pipeline_equals_sequential_and_jax(gloo_results, jax_results):
    ws, xs = W.pipeline_inputs()
    want = xs
    for i in range(W.S):
        want = np.tanh(want @ ws[i])
    for rank in range(4):
        got = gloo_results[rank]["pipeline"]
        np.testing.assert_allclose(got, want, atol=PIPE_ATOL, rtol=0)
        np.testing.assert_allclose(got, jax_results["pipeline"],
                                   atol=PIPE_ATOL, rtol=0)
    assert pipeline.bubble_fraction(4, 6) == pytest.approx(3 / 9)
    assert pipeline.bubble_fraction(4, 6) == jax_results["bubble"]


def test_pipeline_one_stage_is_the_stack_bit_for_bit(gloo_world_1):
    ws, xs = W.pipeline_inputs()
    stacked = torch.from_numpy(ws)[None]          # one stage: every layer

    def block(wst, x):
        for w in wst:
            x = torch.tanh(x @ w)
        return x
    got = pipeline.pipeline_apply(block, stacked, torch.from_numpy(xs))
    want = torch.stack([block(stacked[0], x) for x in torch.from_numpy(xs)])
    assert torch.equal(got, want)


def test_elastic_restore_across_mesh_sizes(gloo_results):
    leaves = W.elastic_leaves()
    w, e = leaves["w"], torch.from_numpy(leaves["e"]).to(torch.bfloat16)
    for rank in range(4):
        res = gloo_results[rank]
        c = divmod(rank, 2)                    # (data, model) on (2, 2)
        rows, cols = slice(4 * c[0], 4 * c[0] + 4), slice(4 * c[1],
                                                          4 * c[1] + 4)
        assert int(res["manifest_step"]) == 1
        np.testing.assert_array_equal(res["local_w"], w[rows, cols])
        cols_e = slice(3 * c[1], 3 * c[1] + 3)
        np.testing.assert_array_equal(
            res["local_e"], e[rows, cols_e].view(torch.int16).numpy())
        assert list(res["placements_w"]) == ["S(0)", "S(1)"] or \
            list(res["placements_w"]) == ["Shard(dim=0)", "Shard(dim=1)"]


@pytest.mark.parametrize("block", ["slstm", "mlstm", "mlstm_c4"])
def test_xlstm_scans_on_each_ranks_rows(gloo_results, block):
    """8 ranks on a (4, 2) mesh, each running the block's scan on its 2
    rows: the gathered outputs and gradients equal the plain block's on
    all 8 rows (1e-5: a rank's products over 2 rows, and the weights'
    gradients summed over 4 ranks, round apart from one pass over 8)."""
    x, g = (torch.from_numpy(a) for a in W.xlstm_inputs())
    want = {k: v.detach().numpy() for k, v in W.xlstm_blocks(
        x, g, W.xlstm_params()).items() if k.startswith(block + "_")}
    assert f"{block}_y" in want and f"{block}_dx" in want
    assert (f"{block}_dr" in want) == (block == "slstm")
    for rank in range(4):
        res = gloo_results[rank]
        for k, v in want.items():
            np.testing.assert_allclose(res[f"xlstm_{k}"], v, rtol=1e-5,
                                       atol=1e-5, err_msg=f"{k} rank {rank}")
            # the activations keep their batch shard; ``r``'s gradient is
            # summed where the scan hands it back (the weight is read
            # whole), the projections' stay partial sums (DTensor's rule)
            want_pl = (["S(0)", "R"] if k.endswith(("_y", "_dx")) else
                       ["R", "R"] if k == "slstm_dr" else ["P(sum)", "R"])
            assert list(res[f"xlstm_{k}_placements"]) == want_pl, k
        if block == "slstm":                   # rank r holds rows of data r//2
            lo = 2 * (rank // 2)
            np.testing.assert_allclose(res["xlstm_slstm_y_local"],
                                       want["slstm_y"][lo:lo + 2],
                                       rtol=1e-5, atol=1e-5)
