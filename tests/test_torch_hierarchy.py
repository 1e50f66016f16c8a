"""``policy/hierarchy.py`` and the hierarchical mesh in the port: the cases of
``tests/test_hierarchy.py``, run against ``radixmesh_tpu_torch``. Its
serving case builds port engines on the CPU, float32, with the port's
``init_params``, where the JAX case builds JAX engines over a JAX pool."""

from _torch_twin import load_twin

load_twin(
    "test_hierarchy",
    globals(),
    subs=(
        (
            """        import jax

        from radixmesh_tpu.cache.kv_pool import PagedKVPool
""",
            """        import torch

""",
        ),
        (
            """        cfg = ModelConfig.tiny()
        params = init_params(cfg, jax.random.PRNGKey(0))""",
            """        cfg = ModelConfig.tiny().replace(dtype=torch.float32)
        params = init_params(cfg, seed=0, device="cpu")""",
        ),
        (
            """                pool = PagedKVPool(
                    num_slots=512, num_layers=cfg.n_layers,
                    num_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                    page_size=page, dtype=cfg.dtype,
                )
""",
            "",
        ),
        ("cfg, params, pool=pool, page_size=page,", 'cfg, params, num_slots=512, device="cpu", page_size=page,'),
    ),
)
