"""Request lifecycle state for the serving engine.

This package's own copy of the JAX package's ``engine/request.py``, cut to
the fields the ported schedules use (legacy, mixed waves, multi-step and
speculative decode), the staged KV restore (``RESTORING``), seeded replay
and resume admission, and the observability planes (request traces and
the token timeline), and the SLO control plane's fields (tenant,
deadlines, admission, shedding and degradation bookkeeping): the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import enum
import itertools
import threading
import time
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Request", "RequestState", "SamplingParams", "VALID_TRANSITIONS"]

_rid_counter = itertools.count()


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 = greedy
    top_p: float = 1.0
    top_k: int = 0  # 0 = disabled
    max_new_tokens: int = 16
    stop_token_ids: tuple[int, ...] = ()
    # Per-request sampling seed (None = the engine's global stream). With
    # a seed, a sampled token depends only on (seed, absolute position)
    # whenever every row of the launch is seeded — so a request resumed on
    # another engine redraws exactly the continuation its first life drew
    # (``Engine._sample_seeded_row``).
    seed: int | None = None


class RequestState(enum.Enum):
    QUEUED = "queued"
    # Parked while the async KV plane (cache/kv_transfer.py) restores the
    # request's host- or disk-tier prefix into the pool; the engine keeps
    # decoding and re-queues the request when its pages land.
    RESTORING = "restoring"
    RUNNING = "running"
    FINISHED = "finished"


# The admission state machine. FINISHED is terminal (a resumed request is
# a new request); QUEUED re-entry covers the restore-complete requeue and
# preemption; QUEUED -> FINISHED is a cancel or an SLO shed before
# dispatch (``slo/runner.py``).
VALID_TRANSITIONS = {
    (RequestState.QUEUED, RequestState.RUNNING),      # dispatch
    (RequestState.QUEUED, RequestState.RESTORING),    # park for a staged restore
    (RequestState.QUEUED, RequestState.FINISHED),     # cancel or shed before dispatch
    (RequestState.RESTORING, RequestState.QUEUED),    # restore landed: requeue
    (RequestState.RESTORING, RequestState.FINISHED),  # cancel or deadline while parked
    (RequestState.RUNNING, RequestState.QUEUED),      # preempt (pool pressure)
    (RequestState.RUNNING, RequestState.FINISHED),    # stop, cap or cancel
}


@dataclass
class Request:
    prompt: np.ndarray  # int32 token ids
    sampling: SamplingParams = field(default_factory=SamplingParams)
    rid: int = field(default_factory=lambda: next(_rid_counter))

    # -- engine-managed state --
    state: RequestState = RequestState.QUEUED
    output_tokens: list[int] = field(default_factory=list)
    row: int = -1  # decode-batch row while RUNNING
    kv_len: int = 0  # tokens whose KV is in the pool
    prefix_len: int = 0  # tokens reused from the radix cache at prefill
    # Slot index per token position [kv_len]: canonical (tree-owned) slots
    # over the reused prefix, this request's slots after it.
    token_slots: np.ndarray = field(
        default_factory=lambda: np.empty(0, dtype=np.int32)
    )
    # Slots allocated by/for this request (whole pages; superset of the
    # tail of token_slots until handed to the tree or freed).
    own_slots: np.ndarray = field(
        default_factory=lambda: np.empty(0, dtype=np.int32)
    )
    lock_node: object = None  # TreeNode protected while RUNNING
    # Resume admission (``Engine.make_request(resume_tokens=...)``): the
    # last ``resume_offset`` tokens of ``prompt`` are output a prior life of
    # this request already delivered — replayed through prefill (a cache
    # hit where that life published them) but never re-emitted:
    # ``output_tokens`` holds only post-resume tokens.
    resume_offset: int = 0
    cancelled: bool = False  # aborted by Engine.cancel (output is partial)

    # -- SLO control plane (slo/) --
    tenant: str = "default"  # rate-limit, fair-share and speculation-class key
    ttft_deadline_s: float | None = None  # relative to submit_time
    e2e_deadline_s: float | None = None  # relative to submit_time
    admit_time: float = 0.0  # SLO queue -> engine dispatch instant
    # Refused or dropped by the control plane, or by a drain for the client
    # to resubmit elsewhere (``Engine.drain_requeue_waiting``).
    shed: bool = False
    shed_reason: str = ""
    degradation_tier: int = 0  # tier in force when dispatched
    # Backlog cost retired from the controller (first token or a cancel
    # before one): whichever side runs first sets it
    # (``OverloadController.note_retired``).
    slo_retired: bool = False
    # Tree drafting stays on only while it pays: cleared the first time
    # the tree has no continuation for this request, so novel generations
    # never re-walk the whole history every launch.
    tree_draft_ok: bool = True
    # The tree's ``draft_ready_epoch`` this request last peeked at: a
    # later epoch re-arms tree drafting (``Engine._draft_for``).
    draft_epoch: int = 0
    # Draft tokens the last speculative wave rejected for this row: the
    # spec_verify_miss stall attribution, consumed by Engine._stall_cause.
    spec_miss: int = 0
    # Monotonic stamp of the last emitted token (0 = none yet this life):
    # the token timeline's inter-token clock. Reset by Engine._preempt, so
    # a requeued life's first token reads as TTFT, not as a long gap.
    last_token_time: float = 0.0
    # Request-flight tracing (obs/trace_plane.py): a TraceContext when this
    # request won the sampling coin flip, else None; every span site
    # guards with one ``is not None`` branch.
    trace: object = None
    # Stamped by Engine._preempt on requeue: the second admission's queue
    # wait starts here, not at the original submit.
    requeue_time: float = 0.0
    submit_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0
    # Per-request progress wake (server/http_frontend.py): waiters block
    # on this instead of polling. Notified by note_progress() on each
    # appended token and — via __setattr__ — on ANY transition to
    # FINISHED, so no finish site can strand a waiter.
    cond: threading.Condition = field(
        default_factory=threading.Condition, repr=False, compare=False
    )

    def note_progress(self) -> None:
        """Wake every thread blocked on this request."""
        with self.cond:
            self.cond.notify_all()

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if name == "state" and value is RequestState.FINISHED:
            # dict lookup, not attribute access: during dataclass
            # __init__ the state field is assigned before cond exists.
            cond = self.__dict__.get("cond")
            if cond is not None:
                with cond:
                    cond.notify_all()
            # Every finish path (stop token, length cap, cancel, drain)
            # assigns FINISHED here, so a traced request's terminal
            # ``request_done`` span cannot be missed by a new finish site.
            # One ``is not None`` branch when untraced; the _retired guard
            # keeps a double transition from recording it twice.
            tr = self.__dict__.get("trace")
            if (
                tr is not None
                and self.__dict__.get("submit_time")
                and not self.__dict__.get("_retired")
            ):
                object.__setattr__(self, "_retired", True)
                tr.add(
                    "request_done",
                    self.submit_time,
                    time.monotonic() - self.submit_time,
                    cat="scheduler",
                    prompt_tokens=len(self.prompt),
                    output_tokens=len(self.output_tokens),
                    cancelled=bool(self.cancelled),
                    shed=bool(self.shed),
                )

    @property
    def num_tokens(self) -> int:
        return len(self.prompt) + len(self.output_tokens)

    @property
    def generated(self) -> list[int]:
        return list(self.output_tokens)

    def is_finished_by(self, token: int) -> bool:
        return (
            token in self.sampling.stop_token_ids
            or len(self.output_tokens) >= self.sampling.max_new_tokens
        )
