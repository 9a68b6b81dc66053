"""The port's training substrate against the JAX package's: the data
pipeline, the optimizers, checkpoints and the fault-tolerant trainer (the
twins of ``tests/test_substrate.py``'s cases), on the same numpy-seeded
inputs through both packages.

* ``DataPipeline.batch_at``: bit for bit, both sources, shards 0 and 1 of 2.
* ``lr_schedule`` over every step of a schedule, and AdamW / Adafactor /
  SGD after one and three updates of the same f32 parameters and
  gradients: parameters, lr, grad norm and every state leaf within
  ``OPT_TOL`` (the same f32 arithmetic, op for op).
* Checkpoints: the port's round trip (bf16 bits exact), keep policy, async
  save (the host copy is taken before ``save_async`` returns), the atomic
  tmp directory; a JAX-written checkpoint restored by the port and a
  port-written one restored by JAX, bit for bit, trainer state included.
* The trainer at ``_tiny_trainer``'s config, as ``TestTrainer`` runs it:
  the loss falls, a crash resumes from the last checkpoint, the resumed run
  matches the uninterrupted one (JAX's 2e-2), gradient accumulation runs.
"""

import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import DataPipeline as JaxDataPipeline
from repro.optim import optimizers as JO
from repro.train.trainer import TrainConfig as JaxTrainConfig
from repro.train.trainer import Trainer as JaxTrainer
from repro_torch.bridge import to_tensor
from repro_torch.ckpt import checkpoint as C
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.registry import ARCHS
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.optim import optimizers as O
from repro_torch.train.trainer import TrainConfig, Trainer

#: the optimizers' f32 arithmetic, op for op; sums over leaves in JAX's
#: order
OPT_TOL = 1e-6


def _leaves(tree, prefix=""):
    """(path, leaf) in sorted key order, for either package's dicts."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x)


def _bits_equal(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8))


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("source", ["synthetic", "memmap"])
def test_batch_at_is_jax_bit_for_bit(tmp_path, source, shard):
    path = ""
    if source == "memmap":
        path = str(tmp_path / "tokens.bin")
        np.random.default_rng(0).integers(0, 1000, 4096, dtype=np.uint32) \
            .tofile(path)
    kw = dict(vocab=1000, seq_len=16, global_batch=4, seed=3, source=source,
              path=path)
    for step in (0, 5):
        ours = DataPipeline(DataConfig(**kw), shard, 2).batch_at(step)
        theirs = JaxDataPipeline(JaxDataConfig(**kw), shard, 2).batch_at(step)
        assert set(ours) == set(theirs) == {"tokens", "labels"}
        for k in ours:
            assert ours[k].dtype == theirs[k].dtype == np.int32
            np.testing.assert_array_equal(ours[k], theirs[k])


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def test_lr_schedule_matches_jax():
    cfg = O.OptConfig(lr=1e-2, warmup_steps=7, decay_steps=40,
                      min_lr_ratio=0.1)
    jcfg = JO.OptConfig(lr=1e-2, warmup_steps=7, decay_steps=40,
                        min_lr_ratio=0.1)
    steps = np.arange(0, 46, dtype=np.int32)
    ours = [float(O.lr_schedule(cfg, torch.tensor(s))) for s in steps]
    theirs = [float(JO.lr_schedule(jcfg, jnp.asarray(s))) for s in steps]
    np.testing.assert_allclose(ours, theirs, atol=OPT_TOL, rtol=OPT_TOL)
    assert ours[0] == 0.0 and ours[-1] == pytest.approx(1e-3, abs=1e-9)


def _opt_tree(rng):
    """f32 parameters with factored (2-D, stacked 3-D) and unfactored
    (1-D, a column) leaves, nested as a model's are."""
    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"w": f(8, 16), "layers": {"a": f(3, 8, 4), "scale": f(16)},
            "col": f(5, 1)}


@pytest.mark.parametrize("n_updates", [1, 3])
@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_optimizer_matches_jax(name, n_updates):
    rng = np.random.default_rng(1)
    params = _opt_tree(rng)
    grads = [_opt_tree(rng) for _ in range(n_updates)]
    kw = dict(name=name, lr=1e-2, warmup_steps=2, decay_steps=10,
              grad_clip=2.0)
    cfg, jcfg = O.OptConfig(**kw), JO.OptConfig(**kw)
    to_t = lambda tree: jax.tree.map(lambda a: torch.from_numpy(a.copy()),
                                     tree)
    tp = to_t(params)
    ts = O.opt_init(cfg, tp)
    jp = jax.tree.map(jnp.asarray, params)
    js = JO.opt_init(jcfg, jp)
    assert [k for k, _ in _leaves(ts)] == [k for k, _ in _leaves(js)]
    for g in grads:
        tp, ts, tm = O.opt_update(cfg, tp, to_t(g), ts)
        jp, js, jm = JO.opt_update(jcfg, jp, jax.tree.map(jnp.asarray, g), js)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       atol=OPT_TOL, rtol=OPT_TOL)
    assert int(ts["step"]) == int(js["step"]) == n_updates
    assert ts["step"].dtype == torch.int32
    for tree_t, tree_j in ((tp, jp), (ts, js)):
        pairs = list(zip(_leaves(tree_t), _leaves(tree_j)))
        assert [a for (a, _), _ in pairs] == [b for _, (b, _) in pairs]
        for (path, t), (_, j) in pairs:
            np.testing.assert_allclose(_np(t), np.asarray(j), atol=OPT_TOL,
                                       rtol=OPT_TOL, err_msg=path)


def test_master_weights_accumulate():
    """bf16 parameters take 100 updates below their ulp through the f32
    master (``test_substrate.py``'s case)."""
    cfg = O.OptConfig(name="sgd", lr=1e-4, grad_clip=1e9, warmup_steps=0,
                      decay_steps=10**9, min_lr_ratio=1.0)
    params = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    state = O.opt_init(cfg, params)
    g = {"w": torch.ones((4,))}
    for _ in range(100):
        params, state, _ = O.opt_update(cfg, params, g, state)
    assert params["w"].dtype == torch.bfloat16
    assert float(params["w"][0]) < 1.0


def test_adafactor_factored_state_is_small():
    st = O.opt_init(O.OptConfig(name="adafactor"),
                    {"w": torch.ones((128, 64), dtype=torch.bfloat16)})
    assert sum(t.numel() for _, t in _leaves(st["v"])) == 128 + 64


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ckpt_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((3, 4), generator=g)
                       .to(torch.bfloat16),
                       "b": torch.randn((4,), generator=g)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def test_roundtrip_keeps_bf16_bits(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    tree = _ckpt_tree()
    cm.save(7, tree)
    like = _ckpt_tree(seed=1)
    got, manifest = cm.restore(like)
    assert manifest["step"] == 7
    assert manifest["dtypes"] == {"params/w": "bfloat16"}
    for (_, a), (_, b) in zip(_leaves(got), _leaves(tree)):
        _bits_equal(a, b)


def test_keep_policy(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, _ckpt_tree())
    assert cm.all_steps() == [3, 4]
    assert cm.latest_step() == 4


def test_async_save_copies_before_it_returns(tmp_path, monkeypatch):
    """The write waits until the tree has been changed in place: the
    checkpoint still holds the values at the time of the call."""
    cm = CheckpointManager(str(tmp_path))
    tree = _ckpt_tree()
    before = tree["params"]["b"].clone()
    go = threading.Event()
    write = cm._write

    def held(*a):
        assert go.wait(timeout=60)
        write(*a)
    monkeypatch.setattr(cm, "_write", held)
    cm.save_async(3, tree)
    tree["params"]["b"].add_(1.0)
    go.set()
    cm.wait()
    assert cm.latest_step() == 3
    got, _ = cm.restore(_ckpt_tree())
    assert torch.equal(got["params"]["b"], before)


def test_crash_mid_write_leaves_the_last_checkpoint(tmp_path, monkeypatch):
    """A write that dies before ``os.replace`` leaves only its tmp
    directory: the latest checkpoint is still the previous one, whole."""
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, _ckpt_tree())

    def die(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(C.np, "savez", die)
    with pytest.raises(OSError):
        cm.save(2, _ckpt_tree(seed=5))
    monkeypatch.undo()
    assert cm.all_steps() == [1]
    assert any(p.name.startswith(".tmp.2.") for p in tmp_path.iterdir())
    got, manifest = cm.restore(_ckpt_tree(seed=2))
    assert manifest["step"] == 1
    _bits_equal(got["params"]["w"], _ckpt_tree()["params"]["w"])


def _tiny_cfg(pkg_archs):
    return pkg_archs["smollm-360m"].reduced().scaled(
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128, vocab=256,
        head_dim=32, remat=False)


def _tiny_trainer(tmp_path, steps=8, **kw):
    cfg = _tiny_cfg(ARCHS)
    opt = O.OptConfig(lr=1e-3, warmup_steps=2, decay_steps=steps)
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2)
    tcfg = TrainConfig(steps=steps, ckpt_dir=str(tmp_path), ckpt_every=3,
                       log_every=2, **kw)
    return Trainer(cfg, opt, data, tcfg, device="cpu")


def _jax_tiny_trainer(tmp_path, steps):
    cfg = _tiny_cfg(JAX_ARCHS)
    opt = JO.OptConfig(lr=1e-3, warmup_steps=2, decay_steps=steps)
    data = JaxDataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2)
    return JaxTrainer(cfg, opt, data, JaxTrainConfig(
        steps=steps, ckpt_dir=str(tmp_path), ckpt_every=3, log_every=2))


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """A JAX trainer's checkpoint (bf16 params, the f32 AdamW state, the
    int32 step) restores into the port's trainer state bit for bit, and
    the port's trainer resumes from it."""
    jt = _jax_tiny_trainer(tmp_path, steps=3)
    jstate = jt.run()
    tr = _tiny_trainer(tmp_path, steps=5)
    state = tr._restore_or_init()
    assert state.step == 3
    for (kt, t), (kj, j) in zip(_leaves({"p": state.params,
                                         "o": state.opt_state}),
                                _leaves({"p": jstate.params,
                                         "o": jstate.opt_state})):
        assert kt == kj
        _bits_equal(t, j)
    assert all(t.requires_grad for _, t in _leaves(state.params))
    assert tr.run().step == 5


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port's trainer state, written by the port, restores into the
    JAX trainer's structure bit for bit."""
    tr = _tiny_trainer(tmp_path, steps=3)
    state = tr.run()
    jt = _jax_tiny_trainer(tmp_path, steps=3)
    jstate = jt.init_state()
    like = {"params": jstate.params, "opt_state": jstate.opt_state}
    got, manifest = JaxCheckpointManager(str(tmp_path)).restore(like)
    assert manifest["step"] == 3
    assert manifest["dtypes"]["params/embed/emb"] == "bfloat16"
    for (kt, t), (kj, j) in zip(_leaves({"params": state.params,
                                         "opt_state": state.opt_state}),
                                _leaves(got)):
        assert kt == kj
        _bits_equal(t, j)


def test_bf16_crosses_as_uint16(tmp_path):
    """JAX's ``_encode`` bits: a bf16 leaf is stored as ``uint16`` with
    ``bfloat16`` in the manifest, by either package."""
    arr = np.random.default_rng(2).standard_normal((5, 3)) \
        .astype(ml_dtypes.bfloat16)
    JaxCheckpointManager(str(tmp_path / "j")).save(1, {"x": arr})
    CheckpointManager(str(tmp_path / "t")).save(1, {"x": to_tensor(arr,
                                                                   "cpu")})
    for d in ("j", "t"):
        with np.load(tmp_path / d / "step_0000000001" / "arrays.npz") as z:
            assert z["x"].dtype == np.uint16
            np.testing.assert_array_equal(z["x"], arr.view(np.uint16))


# ---------------------------------------------------------------------------
# fault-tolerant trainer (``TestTrainer``'s four)
# ---------------------------------------------------------------------------

def test_trainer_needs_a_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("on a host with a card the default device exists")
    cfg = _tiny_cfg(ARCHS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, O.OptConfig(), DataConfig(vocab=256, seq_len=8,
                                               global_batch=2),
                TrainConfig(ckpt_dir=str(tmp_path)))


def test_loss_decreases(tmp_path):
    tr = _tiny_trainer(tmp_path, steps=30)
    tr.run()
    losses = [m["loss"] for m in tr.metrics_log]
    assert losses[-1] < losses[0], losses
    assert set(tr.metrics_log[0]) == {"loss", "lr", "grad_norm", "step",
                                      "dt"}


def test_crash_restart_resumes(tmp_path):
    tr = _tiny_trainer(tmp_path, steps=8)
    with pytest.raises(RuntimeError, match="injected failure"):
        tr.run(fail_at_step=5)
    # step 3's checkpoint is written by a thread the crash leaves running
    # (a process that died would leave it whole or absent: atomic write)
    tr.ckpt.wait()
    # a new trainer (fresh process semantics) resumes from step 3's ckpt
    tr2 = _tiny_trainer(tmp_path, steps=8)
    assert tr2._restore_or_init().step == 3
    state = tr2.run()
    assert state.step == 8
    assert tr2.ckpt.latest_step() == 8


def test_restart_matches_uninterrupted(tmp_path):
    state_a = _tiny_trainer(tmp_path / "a", steps=6).run()
    trb = _tiny_trainer(tmp_path / "b", steps=6)
    with pytest.raises(RuntimeError):
        trb.run(fail_at_step=4)
    trb.ckpt.wait()
    resumed = _tiny_trainer(tmp_path / "b", steps=6)
    assert resumed._restore_or_init().step == 3
    state_b = resumed.run()
    for (_, x), (_, y) in zip(_leaves(state_a.params),
                              _leaves(state_b.params)):
        np.testing.assert_allclose(x.detach().float().numpy(),
                                   y.detach().float().numpy(),
                                   atol=2e-2, rtol=2e-2)


def test_grad_accum_runs(tmp_path):
    tr = _tiny_trainer(tmp_path, steps=3, grad_accum=2)
    state = tr.run()
    assert state.step == 3
    assert all(np.isfinite(m["loss"]) for m in tr.metrics_log)
