"""Metric hygiene over the port: ``tests/test_metrics_lint.py``'s cases, run
against ``radixmesh_tpu_torch``. The static half reads the port's cached
``check_tree()``; the runtime walk builds one of each instrumented port
component on the CPU, the engine included (the port's ``Engine`` with
``init_params(cfg, 0, "cpu")`` in place of the JAX engine and its
``jax.random`` key), and checks the families that land in the port's
registry."""

from _torch_twin import load_twin

load_twin(
    "test_metrics_lint",
    globals(),
    subs=(
        ("import jax\n", ""),
        ("        init_params(cfg, jax.random.PRNGKey(0)),\n",
         "        init_params(cfg, 0, \"cpu\"),\n        device=\"cpu\",\n"),
    ),
)
