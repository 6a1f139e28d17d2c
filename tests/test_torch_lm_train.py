"""PyTorch port: the LM seed code's train step, checkpoints and launcher
against the JAX package, on the CPU at the reduced configs.

* one ``make_train_step`` step at float32 compute, ``n_micro`` 1 and 2,
  for smollm and granite, and 2 for jamba (tracing and compiling the
  reference's jamba step takes ~12 s a time on the CPU; its n_micro = 2
  step runs the same layers' backward and the accumulation besides),
  from the same weights (numpy):
  the loss, ``grad_norm`` and every updated parameter within
  1e-4 * (1 + max|ref|), the first moment (0.1 x the clipped gradient)
  within 1e-3 of each leaf's largest entry;
* ``remat`` on equals ``remat`` off bit for bit (jamba: attention, SSD
  and MoE in one group); ``grad_compress`` sums the microbatch gradients
  in bf16;
* checkpoints in the reference's layout: a reference ``ckpt.save`` of a
  reduced LM tree with a bf16 leaf restores in the port bit for bit, and
  a port save restores in the reference; torn checkpoints are ignored,
  ``gc`` keeps the newest, ``AsyncCheckpointer`` saves, a shape mismatch
  raises;
* the launcher (``python -m repro_torch.launch.train --device cpu
  --reduced``) killed by ``--simulate-failure 5`` exits 42 with the
  checkpoint of step 2 or 4 (the save of step 4 may still be in flight),
  the rerun (the launcher's ``main``, in-process) resumes from it, and its
  final parameters and optimizer state equal an uninterrupted run's bit
  for bit.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canary import deadline
from repro.ckpt import checkpoint as jck
from repro.configs import base as jbase
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.ckpt import checkpoint as tck
from repro_torch.configs import base as tbase
from repro_torch.launch import train
from repro_torch.models import lm as tlm
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def cfgs(arch):
    return (jbase.reduced(jbase.get_config(arch)),
            tbase.reduced(tbase.get_config(arch)))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def ref_params(tcfg, seed=0):
    """Reference-layout numpy weights, drawn by the port."""
    return tlm.lm_params_to_numpy(tlm.init_params(tcfg, seed, device="cpu"))


def tokens(cfg, b=4, s=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


@pytest.mark.parametrize("arch,n_micro", [
    ("smollm-360m", 1), ("smollm-360m", 2), ("granite-moe-3b-a800m", 1),
    ("granite-moe-3b-a800m", 2), ("jamba-1.5-large-398b", 2)])
def test_train_step_fp32(arch, n_micro):
    jcfg, tcfg = cfgs(arch)
    params = ref_params(tcfg)
    batch = tokens(jcfg)
    jcfg_opt = jopt.AdamWConfig(total_steps=10)
    step = jax.jit(jstep.make_train_step(
        jcfg, jcfg_opt, n_micro=n_micro, compute_dtype=jnp.float32,
        remat=False))
    p2, o2, wm = step(params, jopt.init_opt_state(params), batch)

    model = tlm.lm_params_from_numpy(params, tcfg, "cpu")
    ost = topt.init_opt_state(tlm.param_tree(model))
    tstep_fn = tstep.make_train_step(
        tcfg, topt.AdamWConfig(total_steps=10), n_micro=n_micro,
        compute_dtype=torch.float32, remat=False)
    model, ost, m = tstep_fn(model, ost, to_torch(batch))

    for k in ("loss", "grad_norm"):
        want = float(wm[k])
        assert abs(float(m[k]) - want) <= 1e-4 * (1 + abs(want)), k
    got_p = tlm.lm_params_to_numpy(model)
    for (name, g), w in zip(topt.tree_items(got_p), jax.tree.leaves(p2)):
        w = np.asarray(w)
        _close(g, w, 1e-4 * (1 + np.abs(w).max()))
    got_m = tlm.to_reference(tlm.numpy_tree(ost["m"]), tcfg)
    for (name, g), w in zip(topt.tree_items(got_m),
                            jax.tree.leaves(o2["m"])):
        w = np.asarray(w)
        _close(g, w, 1e-3 * np.abs(w).max())
    assert int(ost["step"]) == int(o2["step"]) == 1


def test_remat_is_bit_exact():
    jcfg, tcfg = cfgs("jamba-1.5-large-398b")
    params = ref_params(tcfg, seed=1)
    batch = to_torch(tokens(jcfg, seed=1))
    out = []
    for remat in (True, False):
        model = tlm.lm_params_from_numpy(params, tcfg, "cpu")
        ost = topt.init_opt_state(tlm.param_tree(model))
        fn = tstep.make_train_step(tcfg, topt.AdamWConfig(total_steps=10),
                                   compute_dtype=torch.float32, remat=remat)
        model, ost, m = fn(model, ost, batch)
        out.append((tlm.lm_params_to_numpy(model),
                    tlm.numpy_tree(ost["m"]), float(m["loss"])))
    (pa, ma, la), (pb, mb, lb) = out
    assert la == lb
    for a, b in zip(topt.tree_leaves(pa) + topt.tree_leaves(ma),
                    topt.tree_leaves(pb) + topt.tree_leaves(mb)):
        np.testing.assert_array_equal(a, b)


def test_grad_compress_accumulates_in_bf16():
    """``grad_compress``: the microbatch gradients summed in bf16 (the
    reference's accumulator), the loss still in float32."""
    _, tcfg = cfgs("smollm-360m")
    params = ref_params(tcfg, seed=3)
    batch = to_torch(tokens(tcfg, seed=3))
    out = {}
    for compress in (False, True):
        model = tlm.lm_params_from_numpy(params, tcfg, "cpu")
        ost = topt.init_opt_state(tlm.param_tree(model))
        fn = tstep.make_train_step(tcfg, topt.AdamWConfig(total_steps=10),
                                   n_micro=2, compute_dtype=torch.float32,
                                   grad_compress=compress, remat=False)
        model, ost, m = fn(model, ost, batch)
        out[compress] = (float(m["loss"]), topt.tree_leaves(ost["m"]))
    assert out[True][0] == out[False][0]
    diff = False
    for a, b in zip(out[True][1], out[False][1]):
        assert float((a - b).abs().max()) <= 2 ** -7 * float(b.abs().max())
        diff |= not torch.equal(a, b)
    assert diff  # the bf16 sums rounded somewhere


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _lm_tree():
    """A reduced LM tree in the reference's layout with one bf16 leaf."""
    _, tcfg = cfgs("jamba-1.5-large-398b")
    t = ref_params(tcfg, seed=2)
    t["final_norm"] = np.random.default_rng(0).normal(
        0, 1, t["final_norm"].shape).astype(np.float32)
    return t


def _bf16_bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def test_reference_checkpoint_restores_in_port(tmp_path):
    t = _lm_tree()
    jt = dict(t, extra=jnp.asarray(t["embed"][:3]).astype(jnp.bfloat16))
    jck.save(tmp_path, 3, jt)
    target = topt.tree_map(lambda a: torch.from_numpy(np.array(a)), dict(t))
    target["extra"] = torch.zeros((3, t["embed"].shape[1]),
                                  dtype=torch.bfloat16)
    out = tck.restore(tmp_path, 3, target, device="cpu")
    np.testing.assert_array_equal(_bf16_bits(out.pop("extra")),
                                  _bf16_bits(jt["extra"]))
    for (n, a), (_, b) in zip(topt.tree_items(out), topt.tree_items(t)):
        assert a.dtype == torch.float32, n
        np.testing.assert_array_equal(a.numpy(), b)
    _, tcfg = cfgs("jamba-1.5-large-398b")
    model = tlm.lm_params_from_numpy(out, tcfg, "cpu")
    for a, b in zip(topt.tree_leaves(tlm.lm_params_to_numpy(model)),
                    topt.tree_leaves(t)):
        np.testing.assert_array_equal(a, b)


def test_port_checkpoint_restores_in_reference(tmp_path):
    t = _lm_tree()
    _, tcfg = cfgs("jamba-1.5-large-398b")
    tree = tlm.lm_params_to_numpy(tlm.lm_params_from_numpy(t, tcfg, "cpu"))
    extra = torch.from_numpy(t["embed"][:3]).to(torch.bfloat16)
    tck.save(tmp_path, 5, dict(tree, extra=extra,
                               step=np.array(7, np.int32)))
    want = dict(t, extra=jnp.asarray(t["embed"][:3]).astype(jnp.bfloat16),
                step=jnp.int32(7))
    out = jck.restore(tmp_path, 5, jax.eval_shape(lambda: want))
    np.testing.assert_array_equal(_bf16_bits(out.pop("extra")),
                                  _bf16_bits(extra))
    assert int(out.pop("step")) == 7
    want.pop("extra"), want.pop("step")
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(out)[0],
                                jax.tree_util.tree_flatten_with_path(want)[0]):
        assert jax.tree_util.keystr(pa) == jax.tree_util.keystr(pb)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _small_tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": ({"w": torch.ones(5, dtype=torch.bfloat16)},
                  {"w": torch.zeros((2, 2), dtype=torch.int32)})}


def _assert_tree_equal(x, y):
    for a, b in zip(topt.tree_leaves(x), topt.tree_leaves(y)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_torn_checkpoint_gc_and_shape_mismatch(tmp_path):
    t = _small_tree()
    for s in range(6):
        tck.save(tmp_path / "gc", s, t, keep=2)
    assert tck.valid_steps(tmp_path / "gc") == [4, 5]
    tck.save(tmp_path, 1, t)
    tck.save(tmp_path, 2, t)
    (tmp_path / "step_00000002" / "COMMIT").unlink()
    assert tck.latest_step(tmp_path) == 1
    with pytest.raises(FileNotFoundError):
        tck.restore(tmp_path, 2, t)
    _assert_tree_equal(tck.restore(tmp_path, 1, t), t)
    with pytest.raises(ValueError):
        tck.restore(tmp_path, 1, dict(t, a=torch.zeros(4)))
    with pytest.raises(KeyError):
        tck.restore(tmp_path, 1, {"c": torch.zeros(3)})


@deadline(120)
def test_async_checkpointer(tmp_path):
    t = _small_tree()
    acp = tck.AsyncCheckpointer(tmp_path, keep=2)
    acp.save(1, t)
    t["a"].add_(1)  # the snapshot was taken: the save keeps step 1's
    acp.save(2, t)  # waits for 1
    acp.wait()
    assert tck.valid_steps(tmp_path) == [1, 2]
    assert torch.equal(tck.restore(tmp_path, 1, t)["a"],
                       torch.arange(12.0).reshape(3, 4))
    _assert_tree_equal(tck.restore(tmp_path, 2, t), t)
    bad = tck.AsyncCheckpointer(tmp_path / "f" / "g")
    (tmp_path / "f").write_text("a file where the directory should be")
    bad.save(1, t)
    with pytest.raises(OSError):
        bad.wait()


# ---------------------------------------------------------------------------
# the launcher: crash, resume, equal to an uninterrupted run
# ---------------------------------------------------------------------------


ARGS = ["--device", "cpu", "--arch", "smollm-360m", "--reduced",
        "--steps", "6", "--batch", "2", "--seq", "32", "--ckpt-every", "2"]


def _final(ckpt_dir):
    """The step-6 parameters and optimizer state, as saved."""
    out = []
    for d in (Path(ckpt_dir), Path(ckpt_dir) / "opt"):
        with np.load(d / "step_00000006" / "shard_000.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


@deadline(600)
def test_crash_restart_equals_uninterrupted_run(tmp_path, capsys):
    """The crash in a subprocess (``os._exit``); the rerun and an
    uninterrupted run through the launcher's ``main`` in this process."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p1 = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGS,
         "--ckpt-dir", str(tmp_path / "a"), "--simulate-failure", "5"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert p1.returncode == 42, p1.stderr[-2000:]
    last = tck.latest_step(tmp_path / "a")
    assert last in (2, 4)  # the async save of step 4 may have been torn
    capsys.readouterr()
    train.main(ARGS + ["--ckpt-dir", str(tmp_path / "a")])
    assert f"resumed from step {last}" in capsys.readouterr().out
    train.main(ARGS + ["--ckpt-dir", str(tmp_path / "b")])
    assert "resumed" not in capsys.readouterr().out
    for a, b in zip(_final(tmp_path / "a"), _final(tmp_path / "b")):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
