"""radixmesh_tpu_torch — the PyTorch/CUDA port of radixmesh_tpu.

Single-node serving of a Llama-3 model over the radix prefix cache on one
NVIDIA H100: ``models/`` (Llama forwards), ``ops/`` (attention, sampling,
and the two hand-written CUDA kernels of the serving path under
``ops/csrc/``), ``cache/`` (paged KV pool, radix tree), ``engine/`` (the
continuous-batching scheduler), ``server/`` (HTTP) and ``launch.py``.

The package imports ``torch`` and never ``jax``, and nothing of the JAX
package ``radixmesh_tpu``, which stays the reference it is tested against.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
