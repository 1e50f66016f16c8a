"""Request routing over the cache mesh (the port's copy of the JAX
package's ``router/``). The client-side failover over several routers,
``RouterFrontDoor``, is imported from ``router.front_door``, as in the JAX
package.

``CacheAwareRouter`` answers: which prefill node and which decode node
already hold the longest cached prefix of this request's tokens? It reads
the router node's rank-only replica of the mesh tree; on a miss (or during
warm-up) it falls back to consistent hashing so cold traffic still
spreads deterministically.
"""

from radixmesh_tpu_torch.router.cache_aware_router import CacheAwareRouter, RouteResult
from radixmesh_tpu_torch.router.consistent_hash import ConsistentHash

__all__ = ["CacheAwareRouter", "RouteResult", "ConsistentHash"]
