"""The black box: crash-surviving flight-recorder dumps (this package's
copy of the JAX package's ``obs/blackbox.py``; the dump format is the
same byte for byte, so each package's :func:`load_blackbox` reads the
other's dumps).

The telemetry history (``obs/timeseries.py``) gives a process a memory;
this module makes that memory survive the process. Three mechanisms, one
dump directory per node (``launch.py serve --blackbox-dir``):

- **Incremental segments.** Riding the history's ``on_sample`` hook,
  every ``segment_every`` samples the new ring points are written to a
  ``segment-NNNNNN.json`` file via write-to-temp + atomic rename, so a
  ``kill -9`` at any instant leaves every previously completed segment
  intact and loses at most one segment window of history. No partial
  JSON can ever be observed (rename is the commit point).
- **Flush triggers.** :meth:`BlackBox.flush` writes a ``final-N.json``
  artifact carrying the full retained history plus what a post-mortem
  needs: the phase attributor's recent-waterfall ring, the flight
  recorder's raw span export, a doctor's live findings when one is
  attached (both frontends and a model-less node attach their
  ``obs/doctor.py`` ``MeshDoctor``), and the frontend's ``/debug/state`` snapshot. Wired triggers: the
  frontend's close (SIGTERM in ``serve``), ``POST /admin/blackbox``, and
  the **unclean-death watchdog**, a thread that watches the sampler's
  heartbeat and flushes once if sampling ever stalls past its timeout.
- **Post-mortem loading.** :func:`load_blackbox` reads a dump directory
  back into one merged series map (segments + final, deduped by sample
  sequence) and flags ``unclean`` dumps (no final: the kill -9
  signature).

Every dump file is schema-versioned (:data:`BLACKBOX_SCHEMA_VERSION`);
the loader refuses files from a future schema rather than misreading
them. Import-light on purpose (stdlib only).
"""

from __future__ import annotations

import json
import os
import threading
import time

from radixmesh_tpu_torch.obs.metrics import TRANSFER_SECONDS_BUCKETS, get_registry
from radixmesh_tpu_torch.utils.logging import get_logger

__all__ = ["BLACKBOX_SCHEMA_VERSION", "BlackBox", "load_blackbox"]

BLACKBOX_SCHEMA_VERSION = 1


def _atomic_write_json(path: str, obj: dict) -> int:
    """Write-to-temp + rename: a hard kill mid-write leaves the old
    file (or nothing), never a truncated JSON. Returns bytes written."""
    tmp = f"{path}.tmp.{os.getpid()}"
    data = json.dumps(obj, sort_keys=True)
    with open(tmp, "w") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return len(data)


class BlackBox:
    """One node's dump writer. Seams (all optional, duck-typed):
    ``history`` (the segment source + watchdog heartbeat), ``doctor``
    (live findings in the final dump), ``recorder`` (span export;
    callable-or-instance, so ``get_recorder`` survives test swaps),
    ``attributor_fn`` (waterfall report), ``state_fn`` (the
    ``/debug/state`` snapshot)."""

    def __init__(
        self,
        out_dir: str,
        history=None,
        doctor=None,
        recorder=None,
        attributor_fn=None,
        state_fn=None,
        node: str = "node",
        segment_every: int = 30,
        watchdog_timeout_s: float = 0.0,
        max_segments: int = 240,
    ):
        # One subdirectory per node: a shared --blackbox-dir across a
        # local fleet must not interleave nodes' segment counters.
        safe_node = "".join(
            c if c.isalnum() or c in "-_.@" else "_" for c in node
        ) or "node"
        self.dir = os.path.join(out_dir, safe_node)
        os.makedirs(self.dir, exist_ok=True)
        self.node = node
        self.log = get_logger("obs.blackbox")
        self._rotate_prior_dump()
        self.history = history
        self.doctor = doctor
        self.recorder = recorder
        self.attributor_fn = attributor_fn
        self.state_fn = state_fn
        self.segment_every = max(1, int(segment_every))
        self.watchdog_timeout_s = float(watchdog_timeout_s)
        if (
            self.watchdog_timeout_s > 0
            and history is not None
            and self.watchdog_timeout_s <= 2.0 * history.interval_s
        ):
            # A timeout a healthy inter-sample gap can reach would spend
            # the ONE-SHOT unclean-death flush on a false positive at
            # boot — and a genuine wedge months later would then leave
            # no watchdog final at all.
            clamped = 10.0 * history.interval_s
            self.log.warning(
                "blackbox watchdog %.1fs is within reach of the %.1fs "
                "sample interval; clamping to %.1fs",
                self.watchdog_timeout_s, history.interval_s, clamped,
            )
            self.watchdog_timeout_s = clamped
        self.max_segments = max(1, int(max_segments))
        self._lock = threading.Lock()
        self._samples_since_segment = 0
        self._pruned_segments = 0
        self._segments = 0
        self._last_segment_seq = -1
        self._flushes = 0
        self._flush_causes: list[str] = []
        self._watchdog_fired = False
        self._stop = threading.Event()
        self._watchdog: threading.Thread | None = None

        reg = get_registry()
        self._m_flushes = reg.counter(
            "radixmesh_blackbox_flushes_total",
            "black-box final dumps written, by trigger cause",
            ("cause",),
        )
        self._m_segments = reg.counter(
            "radixmesh_blackbox_segments_total",
            "incremental history segments committed (atomic rename)",
        )
        self._m_bytes = reg.counter(
            "radixmesh_blackbox_bytes_total",
            "bytes committed to the black-box dump directory",
        )
        self._m_flush_seconds = reg.histogram(
            "radixmesh_blackbox_flush_seconds",
            "wall cost of one black-box flush (history + spans + "
            "waterfalls + doctor + state)",
            buckets=TRANSFER_SECONDS_BUCKETS,
        )
        self._write_manifest()
        if history is not None:
            history.on_sample = self._on_sample
        if self.watchdog_timeout_s > 0 and history is not None:
            self._watchdog = threading.Thread(
                target=self._watch, daemon=True, name="blackbox-watchdog"
            )
            self._watchdog.start()

    # -- manifest ------------------------------------------------------

    def _rotate_prior_dump(self) -> None:
        """A restarted node must not clobber (or merge into) a previous
        boot's dump — that evidence is exactly what the directory exists
        to preserve, and re-using its numbering would overwrite the old
        segments while a fresh final would erase the kill -9 signature.
        Move any existing dump files into a ``prior-NNN`` subdirectory
        (itself a complete, loadable dump) and start this boot clean."""
        leftovers = [
            n for n in os.listdir(self.dir)
            if n == "MANIFEST.json"
            or (n.startswith(("segment-", "final-")) and n.endswith(".json"))
        ]
        if not leftovers:
            return
        i = 0
        while os.path.exists(os.path.join(self.dir, f"prior-{i:03d}")):
            i += 1
        prior = os.path.join(self.dir, f"prior-{i:03d}")
        os.makedirs(prior)
        for name in leftovers:
            os.replace(
                os.path.join(self.dir, name), os.path.join(prior, name)
            )
        self.log.warning(
            "black-box dir %s held a previous boot's dump (%d files); "
            "rotated to %s",
            self.dir, len(leftovers), prior,
        )

    def _write_manifest(self) -> None:
        n = _atomic_write_json(
            os.path.join(self.dir, "MANIFEST.json"),
            {
                "schema_version": BLACKBOX_SCHEMA_VERSION,
                "node": self.node,
                "created_wall": time.time(),
                "interval_s": (
                    self.history.interval_s
                    if self.history is not None
                    else None
                ),
                "segment_every": self.segment_every,
                "pid": os.getpid(),
            },
        )
        self._m_bytes.inc(n)

    # -- incremental segments ------------------------------------------

    def _on_sample(self, seq: int) -> None:
        """History post-sample hook (sampler thread): commit a segment
        every ``segment_every`` samples."""
        with self._lock:
            self._samples_since_segment += 1
            due = self._samples_since_segment >= self.segment_every
            if due:
                self._samples_since_segment = 0
        if due:
            try:
                self.write_segment()
            except OSError:
                self.log.exception("black-box segment write failed")

    def write_segment(self) -> dict | None:
        """Commit one incremental segment: every ring point newer than
        the last committed segment. Returns the segment summary (None
        when nothing new landed)."""
        if self.history is None:
            return None
        with self._lock:
            since = self._last_segment_seq
            seg_no = self._segments
        body = self.history.dump(since=since)
        if body["points"] == 0 and seg_no > 0:
            return None
        seg = {
            "schema_version": BLACKBOX_SCHEMA_VERSION,
            "kind": "segment",
            "node": self.node,
            "segment": seg_no,
            "seq_range": [since + 1, body["seq"]],
            "wall_offset": body["wall_offset"],
            "interval_s": body["interval_s"],
            "series": body["series"],
        }
        n = _atomic_write_json(
            os.path.join(self.dir, f"segment-{seg_no:06d}.json"), seg
        )
        with self._lock:
            self._segments = seg_no + 1
            self._last_segment_seq = body["seq"]
        self._m_segments.inc()
        self._m_bytes.inc(n)
        # Bounded retention: a long-lived node must not grow the dump
        # dir (and the loader's memory) without limit — slide a window
        # of max_segments, dropping the one that just fell off (its
        # span left the in-process ring long ago).
        drop = seg_no - self.max_segments
        if drop >= 0:
            try:
                os.remove(
                    os.path.join(self.dir, f"segment-{drop:06d}.json")
                )
                with self._lock:
                    self._pruned_segments += 1
            except OSError:
                pass
        return {"segment": seg_no, "seq_range": seg["seq_range"], "bytes": n}

    # -- the flush -----------------------------------------------------

    def flush(self, cause: str) -> dict:
        """Write one ``final-N.json`` artifact: full retained history +
        waterfall ring + span export + live doctor findings + state
        snapshot. Each trigger writes its own numbered final (a drain
        followed by SIGTERM leaves both, each complete); the newest is
        the authoritative post-mortem. Crash-isolated per section — a
        broken seam loses its section, never the dump."""
        t0 = time.monotonic()
        with self._lock:
            n_final = self._flushes
            self._flushes = n_final + 1
            self._flush_causes.append(cause)
        dump: dict = {
            "schema_version": BLACKBOX_SCHEMA_VERSION,
            "kind": "final",
            "node": self.node,
            "cause": cause,
            "final": n_final,
            "wall": time.time(),
        }
        if self.history is not None:
            try:
                dump["history"] = self.history.dump()
                dump["history_stats"] = self.history.stats()
            except Exception:  # noqa: BLE001 — a seam bug must not lose the dump
                self.log.exception("black-box history section failed")
        if self.attributor_fn is not None:
            try:
                attr = self.attributor_fn()
                if attr is not None:
                    dump["waterfall"] = attr.report()
            except Exception:  # noqa: BLE001 — section isolation
                self.log.exception("black-box waterfall section failed")
        if self.recorder is not None:
            try:
                rec = (
                    self.recorder()
                    if callable(self.recorder)
                    else self.recorder
                )
                if rec is not None:
                    dump["spans"] = rec.export_spans()
            except Exception:  # noqa: BLE001 — section isolation
                self.log.exception("black-box span section failed")
        if self.doctor is not None:
            try:
                dump["doctor"] = self.doctor.diagnose()
            except Exception:  # noqa: BLE001 — section isolation
                self.log.exception("black-box doctor section failed")
        if self.state_fn is not None:
            try:
                dump["state"] = self.state_fn()
            except Exception:  # noqa: BLE001 — section isolation
                self.log.exception("black-box state section failed")
        path = os.path.join(self.dir, f"final-{n_final:03d}.json")
        n = _atomic_write_json(path, dump)
        self._m_flushes.labels(cause=cause).inc()
        self._m_bytes.inc(n)
        self._m_flush_seconds.observe(time.monotonic() - t0)
        self.log.info(
            "black box flushed (%s): %d bytes to %s", cause, n, path
        )
        return {"path": path, "cause": cause, "bytes": n, "final": n_final}

    # -- the unclean-death watchdog ------------------------------------

    def _watch(self) -> None:
        """Flush ONCE if the history sampler ever stalls past the
        timeout: a process wedged hard enough to stop its 1 s sampler
        is dying — write the black box while a thread still runs.
        (A SIGKILL outruns any watchdog; the segments are that case's
        artifact.)"""
        while not self._stop.wait(self.watchdog_timeout_s / 2.0):
            if self.history.last_sample_age_s() <= self.watchdog_timeout_s:
                continue
            with self._lock:
                if self._watchdog_fired:
                    return
                self._watchdog_fired = True
            try:
                self.flush("watchdog")
            except Exception:  # noqa: BLE001 — the watchdog must not raise on a dying node
                self.log.exception("watchdog flush failed")
            return

    # -- lifecycle -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "dir": self.dir,
                "segments": self._segments,
                "flushes": self._flushes,
                "flush_causes": list(self._flush_causes),
                "segment_every": self.segment_every,
                "max_segments": self.max_segments,
                "pruned_segments": self._pruned_segments,
                "watchdog_timeout_s": self.watchdog_timeout_s,
            }

    def close(self, flush_cause: str | None = None) -> None:
        """Detach from the history and stop the watchdog; with
        ``flush_cause`` set, write one last final artifact first (the
        SIGTERM path passes "sigterm"; a simulated hard kill passes
        None and leaves segments only)."""
        if flush_cause is not None:
            try:
                self.flush(flush_cause)
            except Exception:  # noqa: BLE001 — exit path
                self.log.exception("close flush failed")
        self._stop.set()
        if self.history is not None and self.history.on_sample == self._on_sample:
            self.history.on_sample = None
        if self._watchdog is not None:
            self._watchdog.join(timeout=2)


# ---------------------------------------------------------------------------
# post-mortem loading
# ---------------------------------------------------------------------------


def load_blackbox(path: str) -> dict:
    """Read one node's dump directory (or a multi-node ``--blackbox-dir``
    root holding exactly one node subdirectory) back into a post-mortem
    input:

    - ``series``: every ring point from every complete segment PLUS the
      newest final dump, merged and deduped by sample sequence.
    - ``unclean``: True when segments exist but no final does — the
      hard-kill signature (the process never reached a flush trigger).
    - ``last_t`` / ``last_seq``: where the recorded history ends (the
      crash-window anchor for unclean dumps).

    Raises ``ValueError`` on an empty directory or a future schema
    version (refuse rather than misread)."""
    if os.path.isfile(os.path.join(path, "MANIFEST.json")):
        node_dir = path
    else:
        subs = sorted(
            d for d in os.listdir(path)
            if os.path.isfile(os.path.join(path, d, "MANIFEST.json"))
        ) if os.path.isdir(path) else []
        if len(subs) != 1:
            raise ValueError(
                f"{path}: not a black-box dump (want a MANIFEST.json or "
                f"exactly one node subdirectory; found {subs})"
            )
        node_dir = os.path.join(path, subs[0])
    with open(os.path.join(node_dir, "MANIFEST.json")) as fh:
        manifest = json.load(fh)
    if manifest.get("schema_version", 0) > BLACKBOX_SCHEMA_VERSION:
        raise ValueError(
            f"black-box schema {manifest.get('schema_version')} is newer "
            f"than this reader ({BLACKBOX_SCHEMA_VERSION})"
        )
    segments: list[dict] = []
    finals: list[dict] = []
    for name in sorted(os.listdir(node_dir)):
        full = os.path.join(node_dir, name)
        if name.startswith("segment-") and name.endswith(".json"):
            with open(full) as fh:
                segments.append(json.load(fh))
        elif name.startswith("final-") and name.endswith(".json"):
            with open(full) as fh:
                finals.append(json.load(fh))
    # Merge: seq-keyed dedupe per series; finals carry the full ring so
    # the newest final wins ties (identical points either way).
    merged: dict[str, dict[int, tuple[float, float]]] = {}

    def fold(series: dict) -> None:
        for name, body in series.items():
            dst = merged.setdefault(name, {})
            for seq, t, v in body.get("points", ()):
                dst[int(seq)] = (float(t), float(v))

    for seg in segments:
        fold(seg.get("series", {}))
    final = finals[-1] if finals else None
    if final is not None and "history" in final:
        fold(final["history"].get("series", {}))
    series = {
        name: [[seq, t, v] for seq, (t, v) in sorted(pts.items())]
        for name, pts in sorted(merged.items())
    }
    last_seq = -1
    last_t = None
    for pts in series.values():
        if pts and pts[-1][0] > last_seq:
            last_seq, last_t = pts[-1][0], pts[-1][1]
    return {
        "node": manifest.get("node", "node"),
        "manifest": manifest,
        "schema_version": manifest.get("schema_version"),
        "segments": len(segments),
        "finals": len(finals),
        "final": final,
        "causes": [f.get("cause") for f in finals],
        # No final = unclean: every graceful exit path (shutdown,
        # drain, SIGTERM, watchdog) writes one, so even a manifest-only
        # dir — a node that died before its first segment commit — is
        # the unclean-death signature, not a clean dump.
        "unclean": not finals,
        "interval_s": manifest.get("interval_s"),
        "wall_offset": (
            segments[0].get("wall_offset")
            if segments
            else (final or {}).get("history", {}).get("wall_offset", 0.0)
        ),
        "series": series,
        "last_seq": last_seq,
        "last_t": last_t,
    }
