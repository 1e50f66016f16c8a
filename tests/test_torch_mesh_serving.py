"""The cache mesh wired into the port's engine
(``radixmesh_tpu_torch/engine/engine.py``'s ``mesh=`` seam): every case of
``tests/test_mesh_serving.py``, run against ``radixmesh_tpu_torch``. Its
``ServingCluster`` builds port engines on the CPU, float32, with the port's
``init_params``, each over an external pool (``pool=``, the port's
``PagedKVPool`` on the CPU: the engine runs on its pool's device), where the
JAX one builds JAX engines over a JAX pool; every assertion is the JAX
file's. One case's data changes: the port's engine refuses token ids
outside the vocabulary (a CUDA embedding lookup would fault on them), where
the JAX engine's gather clamps them, so the two churn prompts of
``test_dup_gc_while_preempted_requests_requeue`` (ids 500-615 against the
tiny model's 512) move into the vocabulary. ``test_torch_mesh_parity.py``
runs one script through both packages and compares them."""

from _torch_twin import load_twin

load_twin(
    "test_mesh_serving",
    globals(),
    subs=(
        ("import jax\n", "import torch\n"),
        (
            """        self.cfg = ModelConfig.tiny()
        params = init_params(self.cfg, jax.random.PRNGKey(0))""",
            """        self.cfg = ModelConfig.tiny().replace(dtype=torch.float32)
        params = init_params(self.cfg, seed=0, device="cpu")""",
        ),
        (
            "for x in (list(range(500, 516)), list(range(600, 616)))",
            "for x in (list(range(440, 456)), list(range(460, 476)))",
        ),
    ),
)
