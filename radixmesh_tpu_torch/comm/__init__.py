"""Transports (the JAX package's ``comm/``): the :class:`Communicator`
interface, the in-process hub and the pure-Python TCP transport. The
disaggregated handoff (``engine/disagg.py``) sends its packets over them."""
