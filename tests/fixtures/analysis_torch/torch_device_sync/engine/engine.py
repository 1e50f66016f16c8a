"""Seeded torch device syncs and host copies of pool gathers inside the
serving loop: each stalls the scheduler on the card (the staging module
is the one sync owner)."""

import numpy as np
import torch


class Engine:
    def __init__(self, pool, stream):
        self.pool = pool
        self._stream = stream

    def step(self, slots, tokens):
        torch.cuda.synchronize()  # seeded: hotpath-sync, hotpath-blocking
        self._stream.synchronize()  # seeded: hotpath-sync, hotpath-blocking
        torch.cuda.current_stream(self.pool.device).synchronize()  # seeded: hotpath-sync, hotpath-blocking
        kv = self.pool.gather(slots).cpu()  # seeded: hotpath-sync
        raw = self.pool.gather_raw(slots)[0].to("cpu")  # seeded: hotpath-sync
        arr = np.asarray(self.pool.gather(slots))  # seeded: hotpath-sync
        sampled = tokens.cpu().numpy()  # the step's sampled tokens: legal
        return kv, raw, arr, sampled
