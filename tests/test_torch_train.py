"""The port's training step (``radixmesh_tpu_torch/parallel/train.py``) against
the JAX package's ``make_train_step``, and the twin of
``tests/test_multihost.py::test_two_process_global_mesh_train_step`` over
``launch.py multihost-dryrun``.

float32 ``tiny()`` params from the JAX ``init_params``, converted by
``params_from_jax``; one batch of 4 x 17 tokens. One SGD (1e-2) step: the
loss and every updated leaf within 1e-5 of JAX's, on one device and on the
(dp, sp, tp) meshes (2,1,1), (1,2,1), (1,1,2) and (1,2,2). AdamW (optax's
``adamw(1e-3)`` settings): three steps' losses within 1e-4. On a mesh every
rank's trained tree (each leaf gathered over the axes that shard it) is bit
for bit the same: the replicated leaves stayed equal.

The port's ranks are four processes over gloo (``tests/_torch_ranks.py``,
one group for the file, the functions in ``tests/_torch_train_cases.py``);
the JAX steps run here on conftest's virtual devices, each on its own
mesh.
"""

import functools
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from radixmesh_tpu.models import llama as jl
from radixmesh_tpu.parallel.sharding import MeshPlan as JPlan
from radixmesh_tpu.parallel.sharding import make_mesh as j_make_mesh
from radixmesh_tpu.parallel.train import TrainState as JTrainState
from radixmesh_tpu.parallel.train import make_train_step as j_make_train_step
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import Llama, ModelConfig
from radixmesh_tpu_torch.ops import wquant
from radixmesh_tpu_torch.parallel import MeshPlan, ProcessMesh, make_mesh
from radixmesh_tpu_torch.parallel.train import (
    adamw,
    causal_lm_loss,
    make_train_state,
    make_train_step,
    run_dryrun_train_step,
    trainable,
)
from tests._torch_ranks import REPO, RankGroup

torch.set_num_threads(1)

JCFG = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
TCFG = ModelConfig.tiny().replace(dtype=torch.float32)
JPARAMS = jl.init_params(JCFG, jax.random.PRNGKey(0))
NP_PARAMS = jax.tree_util.tree_map(np.asarray, JPARAMS)
TOKENS = np.random.default_rng(0).integers(0, JCFG.vocab_size, (4, 17)).astype(np.int64)
CASES = "tests._torch_train_cases:"
JOPT = {"sgd": optax.sgd(1e-2), "adamw": optax.adamw(1e-3)}
TOPT = {"sgd": lambda ps: torch.optim.SGD(ps, lr=1e-2), "adamw": adamw}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = RankGroup(4, str(tmp_path_factory.mktemp("ranks")))
    yield g
    g.close()


@functools.lru_cache(maxsize=None)
def jax_steps(plan: tuple, opt: str, steps: int):
    """JAX's ``make_train_step`` on ``plan``'s mesh: the losses and the
    trained params (numpy)."""
    mesh = j_make_mesh(JPlan(*plan))
    state = JTrainState(JPARAMS, JOPT[opt].init(JPARAMS), jnp.zeros((), jnp.int32))
    step = j_make_train_step(JCFG, mesh, JOPT[opt])
    losses = []
    for _ in range(steps):
        state, loss = step(state, jnp.asarray(TOKENS, jnp.int32))
        losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, state.params)


def _assert_tree_close(got: dict, want: dict, atol: float, path: str = ""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k], atol, f"{path}{k}.")
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=path + k)


def _assert_tree_equal(a: dict, b: dict):
    for k in a:
        if isinstance(a[k], dict):
            _assert_tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _np_tree(tree: dict) -> dict:
    return {k: _np_tree(v) if isinstance(v, dict) else v.detach().numpy() for k, v in tree.items()}


def test_single_device_sgd_step_matches_jax():
    losses, want = jax_steps((1, 1, 1), "sgd", 1)
    state = make_train_state(TCFG, optimizer=TOPT["sgd"], device="cpu",
                             params=params_from_jax(NP_PARAMS, TCFG, "cpu"))
    state, loss = make_train_step(TCFG, None, TOPT["sgd"])(state, torch.as_tensor(TOKENS))
    assert state.step == 1
    assert abs(float(loss) - losses[0]) < 1e-5
    _assert_tree_close(_np_tree(state.params.param_tree()), want, 1e-5)
    # The step moved every leaf but the norms' (SGD on a random model).
    assert np.abs(_np_tree(state.params.param_tree())["layers"]["wq"] - NP_PARAMS["layers"]["wq"]).max() > 0


@pytest.mark.parametrize("plan", [(2, 1, 1), (1, 2, 1), (1, 1, 2), (1, 2, 2)])
def test_mesh_sgd_step_matches_jax(group, plan):
    losses, want = jax_steps(plan, "sgd", 1)
    res = [r for r in group.run(CASES + "train_steps", NP_PARAMS, TCFG, plan + (1,), TOKENS, "sgd", 1)
           if r is not None]
    assert len(res) == int(np.prod(plan))
    for r in res:
        assert abs(r["losses"][0] - losses[0]) < 1e-5
        _assert_tree_close(r["whole"], want, 1e-5)
        _assert_tree_equal(r["whole"], res[0]["whole"])
        assert r["grad_norm"] == res[0]["grad_norm"] > 0


def test_adamw_three_steps_match_jax(group):
    losses, _ = jax_steps((1, 2, 2), "adamw", 3)
    res = [r for r in group.run(CASES + "train_steps", NP_PARAMS, TCFG, (1, 2, 2, 1), TOKENS, "adamw", 3)
           if r is not None]
    assert len(res) == 4
    for r in res:
        np.testing.assert_allclose(r["losses"], losses, rtol=0, atol=1e-4)
        _assert_tree_equal(r["whole"], res[0]["whole"])
    state = make_train_state(TCFG, optimizer=adamw, device="cpu", params=params_from_jax(NP_PARAMS, TCFG, "cpu"))
    step = make_train_step(TCFG, None, adamw)
    one = []
    for _ in range(3):
        state, loss = step(state, torch.as_tensor(TOKENS))
        one.append(float(loss))
    np.testing.assert_allclose(one, losses, rtol=0, atol=1e-4)
    assert one[2] < one[0]


def test_loss_is_the_global_mean_on_every_rank(group):
    """The same loss (no step) from the whole model on one device and from
    the (dp, sp) blocks of a mesh: each rank's share over the global count,
    summed."""
    model = Llama(TCFG, params_from_jax(NP_PARAMS, TCFG, "cpu"))
    with torch.no_grad():
        want = float(causal_lm_loss(model, torch.as_tensor(TOKENS)))
    res = [r for r in group.run(CASES + "train_steps", NP_PARAMS, TCFG, (2, 2, 1, 1), TOKENS, "sgd", 1)
           if r is not None]
    assert len(res) == 4 and all(abs(r["losses"][0] - want) < 1e-5 for r in res)


def test_training_refuses_what_it_cannot_train():
    w8 = params_from_jax(wquant.random_w8_params(TCFG, 0), TCFG, "cpu")
    with pytest.raises(ValueError, match="W8A16"):
        trainable(Llama(TCFG, w8))
    with pytest.raises(ValueError, match="W8A16"):
        make_train_state(TCFG, device="cpu", params=w8)
    stage = ProcessMesh(plan=MeshPlan(pp=2), rank=0, coords=(0, 0, 0, 0), backend=None, groups={},
                        lines={})
    with pytest.raises(ValueError, match="make_pp_train_step"):
        make_train_step(TCFG, stage, adamw)
    if not torch.cuda.is_available():
        # No fallback: a training entry point asked for CUDA raises here.
        with pytest.raises(RuntimeError, match="CUDA"):
            make_train_state(TCFG)
        with pytest.raises(RuntimeError, match="CUDA"):
            run_dryrun_train_step(None)


def _dryrun(pid: int, n: int, store: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "radixmesh_tpu_torch.launch", "multihost-dryrun",
         "--coordinator", f"file://{store}", "--num-processes", str(n), "--process-id", str(pid),
         "--local-devices", "2", "--mesh", "1,2,2", "--backend", "gloo", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_four_process_global_mesh_train_step(tmp_path):
    """Twin of ``test_multihost.py::test_two_process_global_mesh_train_step``:
    four ``multihost-dryrun`` processes (two "hosts" of two ranks) form one
    (dp, sp, tp) = (1, 2, 2) mesh and print the same loss, equal within
    5e-3 to the same dryrun on one device in this process."""
    store = str(tmp_path / "store")
    procs = [_dryrun(i, 4, store) for i in range(4)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost dryrun hung")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} rc={p.returncode}:\n{out[-2000:]}"
    losses = []
    for pid, out in enumerate(outs):
        m = re.search(rf"multihost-dryrun: proc {pid}/4 devices 2 local / 4 global "
                      r"mesh=(\{[^}]*\}) loss=([\d.]+)", out)
        assert m, f"missing dryrun line in:\n{out[-2000:]}"
        assert m.group(1) == "{'dp': 1, 'pp': 1, 'sp': 2, 'tp': 2}"
        losses.append(float(m.group(2)))
    assert len(set(losses)) == 1, losses
    single = run_dryrun_train_step(make_mesh(MeshPlan()), device="cpu")
    assert abs(losses[0] - single) < 5e-3, (losses, single)
