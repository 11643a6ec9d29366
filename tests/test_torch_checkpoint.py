"""The port's fault-tolerance contract (``checkpoint/checkpointer.py`` and
``Trainer``'s resume) on the CPU: tests/test_checkpoint.py's four tests on
the port — bitwise save and restore, resume equal to an uninterrupted run
(bitwise here), a crash mid-write leaving the last commit intact, garbage
collection keeping the last k — then checkpoints across the two packages
(the JAX Trainer's restores in the port's, the port's in the JAX
package's), a bfloat16 checkpoint (its bytes those the reference writes,
which the reference itself cannot restore: ROADMAP C8), and the two
training drivers' resume."""
import dataclasses
import io
import os
import shutil
import zipfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

import torch_training_parity as tp  # noqa: E402
from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.training.data import SyntheticLMData as JLMData  # noqa: E402
from repro.training.optimizer import AdamWConfig as JAdamW  # noqa: E402
from repro.training.train_loop import Trainer as JTrainer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.examples import train_100m  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.training.data import SyntheticLMData  # noqa: E402
from repro_torch.training.optimizer import (AdamWConfig,  # noqa: E402
                                            init_opt_state, tree_leaves)
from repro_torch.training.train_loop import Trainer  # noqa: E402

ARCH = "gemma-7b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: several test workers on one
    machine would otherwise oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def tiny(tmp_path):
    cfg = get_smoke_config(ARCH)
    data = SyntheticLMData(cfg.vocab_size, 16, 4, seed=2)
    return cfg, data, str(tmp_path)


def _trainer(cfg, data, d=None, every=50, **kw):
    return Trainer(cfg, data, AdamWConfig(lr=1e-3, **kw), checkpoint_dir=d,
                   checkpoint_every=every, device="cpu")


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _state_equal(tr, restored):
    params, opt, _ = restored
    return (_equal(tr.params, params) and _equal(tr.opt_state["m"], opt["m"])
            and _equal(tr.opt_state["v"], opt["v"])
            and int(tr.opt_state["step"]) == int(opt["step"]))


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py on the port
# ---------------------------------------------------------------------------


def test_save_restore_bitwise(tiny):
    cfg, data, d = tiny
    tr = _trainer(cfg, data, d, every=5)
    tr.run(6, log_every=100, log=None)
    tr2 = _trainer(cfg, data, d)
    assert tr2.step == 6  # the final save
    ref = Checkpointer(d, cfg, device="cpu").restore(tr2.step)
    assert _state_equal(tr2, ref) and _state_equal(tr, ref)
    assert tr2.opt_state["step"].dtype == torch.int64
    assert Checkpointer(d, cfg, device="cpu").list_steps() == [5, 6]


def test_resume_equals_uninterrupted_run(tiny):
    """Kill-and-resume gives the straight run's losses, bit for bit on the
    CPU (pure data pipeline + bitwise state restore)."""
    cfg, data, d = tiny
    h_solo = _trainer(cfg, data).run(8, log_every=100, log=None)
    _trainer(cfg, data, d, every=4).run(4, log_every=100, log=None)
    b = _trainer(cfg, data, d, every=4)
    assert b.step == 4
    h_resumed = b.run(8, log_every=100, log=None)
    np.testing.assert_array_equal(h_resumed, h_solo[4:])


def test_crash_mid_write_leaves_last_commit_intact(tiny):
    cfg, data, d = tiny
    tr = Trainer(cfg, data, AdamWConfig(), checkpoint_dir=d,
                 checkpoint_every=3, device="cpu")
    tr.run(3, log_every=100, log=None)
    ck = Checkpointer(d, cfg, device="cpu")
    # a crash: a stray .tmp dir from an interrupted save
    os.makedirs(os.path.join(d, "step_00000099.tmp"))
    with open(os.path.join(d, "step_00000099.tmp", "params.npz"), "w") as f:
        f.write("garbage")
    steps = ck.list_steps()
    assert 99 not in steps and steps[-1] == 3
    restored = ck.restore_latest()
    assert restored is not None and restored[2] == 3
    assert _state_equal(tr, restored)


def test_gc_keeps_last_k(tiny):
    cfg, data, d = tiny
    tr = Trainer(cfg, data, AdamWConfig(), checkpoint_dir=d,
                 checkpoint_every=1, device="cpu")
    tr.run(5, log_every=100, log=None)
    assert Checkpointer(d, cfg, device="cpu").list_steps() == [3, 4, 5]


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------


def _jax_flat(tree):
    return tp.flat(jax.device_get(tree))


def test_jax_checkpoint_restores_in_port(tmp_path):
    """A checkpoint the JAX Trainer wrote restores in the port's Trainer
    leaf for leaf, and the next step's loss is the JAX run's."""
    jcfg, cfg = j_smoke(ARCH), get_smoke_config(ARCH)
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    jtr = JTrainer(jcfg, JLMData(cfg.vocab_size, 16, 4, seed=2),
                   JAdamW(lr=1e-3, warmup_steps=2), checkpoint_dir=jd,
                   checkpoint_every=3)
    jtr.run(3, log_every=100, log=None)
    shutil.copytree(jd, pd)
    tr = Trainer(cfg, SyntheticLMData(cfg.vocab_size, 16, 4, seed=2),
                 AdamWConfig(lr=1e-3, warmup_steps=2), checkpoint_dir=pd,
                 device="cpu")
    assert tr.step == 3 and int(tr.opt_state["step"]) == 3
    jparams, jopt, _ = JCheckpointer(jd).restore(3)
    for got, want in ((tr.params, jparams), (tr.opt_state["m"], jopt["m"]),
                      (tr.opt_state["v"], jopt["v"])):
        got = tp.flat(convert.lm_params_to_numpy(got))
        want = _jax_flat(want)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert all(t.dtype == torch.float32 for t in tree_leaves(tr.params))
    got, want = tr.run(4, log=None), jtr.run(4, log=None)
    np.testing.assert_allclose(got, want, rtol=tp.HIST_RTOL)


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port's float32 checkpoint restores in the JAX Checkpointer
    equal, and the JAX Trainer resumes from it to the port's next loss."""
    jcfg, cfg = j_smoke(ARCH), get_smoke_config(ARCH)
    pd, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    _, _, jp, params = tp.models(ARCH)
    tr = Trainer(cfg, SyntheticLMData(cfg.vocab_size, 16, 4, seed=2),
                 AdamWConfig(lr=1e-3, warmup_steps=2), checkpoint_dir=pd,
                 checkpoint_every=3, device="cpu", params=params)
    tr.run(3, log_every=100, log=None)
    shutil.copytree(pd, jd)
    jparams, jopt, step = JCheckpointer(jd).restore(3)
    assert step == 3 and int(jopt["step"]) == 3
    for got, want in ((jparams, tr.params), (jopt["m"], tr.opt_state["m"]),
                      (jopt["v"], tr.opt_state["v"])):
        got = _jax_flat(got)
        want = tp.flat(convert.lm_params_to_numpy(want))
        assert got.keys() == want.keys() == _jax_flat(jp).keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jtr = JTrainer(jcfg, JLMData(cfg.vocab_size, 16, 4, seed=2),
                   JAdamW(lr=1e-3, warmup_steps=2), checkpoint_dir=jd)
    assert jtr.step == 3
    np.testing.assert_allclose(jtr.run(4, log=None), tr.run(4, log=None),
                               rtol=tp.HIST_RTOL)


def test_bfloat16_checkpoint_round_trips(tmp_path):
    """A bfloat16 model's checkpoint: every leaf restores bit for bit in its
    dtype (the MoE router float32 beside bfloat16 weights, the moments
    float32); each npz entry holds the bytes np.savez writes for the same
    ml_dtypes.bfloat16 array; and the reference's restore of it raises
    (ROADMAP C8: jnp.asarray of the |V2 entries)."""
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                              dtype="bfloat16")
    params = model_zoo.init_params(cfg, 0, device="cpu")
    opt = init_opt_state(params)
    d = str(tmp_path)
    ck = Checkpointer(d, cfg, device="cpu")
    ck.save(params, opt, 7)
    rp, ro, step = ck.restore(7)
    assert step == 7 and _equal(rp, params) and _equal(ro["m"], opt["m"])
    dtypes = {t.dtype for t in tree_leaves(rp)}
    assert dtypes == {torch.bfloat16, torch.float32}
    assert all(t.dtype == torch.float32 for t in tree_leaves(ro["v"]))

    flat = tp.flat(convert.lm_params_to_numpy(params))  # float32 values
    kinds = {t.dtype: 0 for t in tree_leaves(params)}
    path = os.path.join(d, "step_00000007", "params.npz")
    want = io.BytesIO()
    arrays = {}
    with np.load(path) as f:
        for k in f.files:
            kinds[torch.bfloat16 if f[k].dtype.kind == "V"
                  else torch.float32] += 1
            arrays[k] = flat["/" + k].astype(
                ml_dtypes.bfloat16 if f[k].dtype.kind == "V" else np.float32)
    np.savez(want, **arrays)
    with zipfile.ZipFile(path) as got, zipfile.ZipFile(want) as ref:
        assert got.namelist() == ref.namelist()
        for name in ref.namelist():
            assert got.read(name) == ref.read(name), name
    assert kinds[torch.bfloat16] > 0 and kinds[torch.float32] > 0
    with pytest.raises(TypeError, match="V2"):
        JCheckpointer(d).restore(7)


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------


def test_train_cli_resumes(tmp_path, capsys):
    """launch/train.py on the CPU: 3 steps with a checkpoint every 2, then
    the same command to 5 resumes at 3."""
    argv = ["--arch", "phi3-medium-14b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--checkpoint-dir",
            str(tmp_path), "--checkpoint-every", "2"]
    hist = train.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "arch=phi3-medium-14b-smoke" in out and "final loss" in out
    assert len(hist) == 3 and all(np.isfinite(hist))
    assert len(train.main(argv + ["--steps", "5"])) == 2


def test_train_100m_example_runs(tmp_path, capsys):
    """The example's default (lm-14m) config, two steps on the CPU; the
    100M config's widths."""
    hist = train_100m.main(["--steps", "2", "--batch", "2", "--seq", "16",
                            "--device", "cpu", "--checkpoint-dir",
                            str(tmp_path)])
    assert len(hist) == 2 and "model lm-14m" in capsys.readouterr().out
    full = train_100m.make_cfg(True)
    assert (full.num_layers, full.d_model, full.num_heads, full.vocab_size,
            full.dtype) == (12, 768, 12, 8192, "float32")
    assert 95e6 < full.param_count() < 110e6
