"""Durable checkpoint management: manifest, retention and verified
fallback (the port's copy of flexflow_tpu/runtime/durability.py, over
runtime/checkpoint.py's file format).

runtime/checkpoint.py makes a single checkpoint file atomic and
self-verifying; this layer makes a checkpoint DIRECTORY survivable. A
`DurableCheckpointer` owns one directory:

    ckpt_dir/
      MANIFEST.json        last-K retained checkpoints, newest last
      ckpt_000000.npz      one atomic, CRC32-checksummed file per save
      ckpt_000005.npz
      ...

MANIFEST.json is itself written atomically (temp + fsync + rename), so the
directory always describes a consistent set of checkpoints. `save` appends
an entry and garbage-collects beyond `keep_last`; `restore_latest` walks
the manifest newest to oldest, verifies each candidate's checksums, and
restores the first one that passes, in place: a torn, corrupt or missing
newest file degrades to a fallback (recorded in `events` and in the
process-wide `ff_checkpoint_*_total` counters), and only when NO
retained checkpoint survives does it raise CheckpointError. Each save
and restore is one span (`checkpoint.save`, `checkpoint.restore`,
obs/tracing.py). On a mesh every rank of it calls `save` and
`restore_latest`; the mesh's leader (runtime/checkpoint.py `holders`)
writes the file and the manifest,
then sends the ranks what its retention removed (one broadcast over the
mesh's group, which is also the barrier before any restore), so every
rank's event log holds the same `checkpoint.gc` records.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..obs.registry import REGISTRY
from ..obs.tracing import get_tracer
from .checkpoint import (CheckpointError, _fsync_dir, holders,
                         restore_checkpoint, save_checkpoint,
                         verify_checkpoint)

MANIFEST_NAME = "MANIFEST.json"
MANIFEST_VERSION = 1

# process-wide durability counters, ff_checkpoint_<kind>_total on the
# metrics registry; the accessors below read and reset them
_COUNTER_PREFIX = "ff_checkpoint_"


def _bump(kind: str, n: int = 1) -> None:
    REGISTRY.counter(
        f"{_COUNTER_PREFIX}{kind}_total",
        f"Durable checkpoint events: {kind}").inc(n)


def checkpoint_counters() -> Dict[str, int]:
    """Snapshot of the process-wide checkpoint counters: saved, restored,
    verified, corrupt, fallback, gc_removed."""
    return REGISTRY.counters_with_prefix(_COUNTER_PREFIX)


def reset_checkpoint_counters() -> None:
    REGISTRY.reset_all(prefix=_COUNTER_PREFIX)


class DurableCheckpointer:
    """Manifest-tracked, last-K-retained, verify-on-restore checkpoints.

    events: any object with `record(kind, **details)` (the elastic
    EventLog, which elastic/coordinator.py shares): corruption
    discoveries, fallbacks and GC land there as `checkpoint.corrupt` /
    `checkpoint.fallback` / `checkpoint.gc` records."""

    def __init__(self, directory: str, keep_last: int = 3,
                 events: Optional[Any] = None):
        self.directory = directory
        self.keep_last = max(1, keep_last)
        self.events = events
        # the steps this process wrote (on a mesh, only its leader writes)
        self.written: List[int] = []
        os.makedirs(directory, exist_ok=True)

    # -- manifest ---------------------------------------------------------
    @property
    def manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST_NAME)

    def entries(self) -> List[Dict[str, Any]]:
        """Manifest entries, oldest first. Falls back to a directory scan
        when the manifest is missing (e.g. a pre-durability checkpoint dir
        or a manifest lost to a crash before its first write)."""
        if os.path.exists(self.manifest_path):
            try:
                with open(self.manifest_path) as f:
                    return list(json.load(f).get("checkpoints", []))
            except (OSError, ValueError):
                pass  # torn manifest: scan instead — files are the truth
        return [{"step": None, "file": fname}
                for fname in sorted(os.listdir(self.directory))
                if fname.startswith("ckpt_") and fname.endswith(".npz")]

    def _write_manifest(self, entries: List[Dict[str, Any]]) -> None:
        payload = {"format": "flexflow_tpu_checkpoint_manifest",
                   "version": MANIFEST_VERSION,
                   "keep_last": self.keep_last,
                   "checkpoints": entries}
        tmp = f"{self.manifest_path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.manifest_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        _fsync_dir(self.manifest_path)

    def _record(self, kind: str, **details) -> None:
        if self.events is not None:
            self.events.record(kind, **details)

    # -- save + GC --------------------------------------------------------
    def save(self, model, step: int) -> str:
        """Atomic checkpoint write + manifest update + retention GC.
        Returns the checkpoint path."""
        fname = f"ckpt_{step:06d}.npz"
        with get_tracer().span("checkpoint.save", step=int(step)):
            path = save_checkpoint(os.path.join(self.directory, fname),
                                   model, step=step)
        _bump("saved")
        held = holders(model)
        removed = None
        if held is None or torch.distributed.get_rank() == held[0]:
            removed = self._commit(fname, path, step)
            self.written.append(int(step))
        if held is not None:  # the manifest is written before any restore
            box = [removed]
            torch.distributed.broadcast_object_list(box, src=held[0],
                                                    group=held[1])
            removed = box[0]
        for e, p in removed:
            _bump("gc_removed")
            self._record("checkpoint.gc", step=e.get("step", -1), path=p)
        return path

    def _commit(self, fname: str, path: str, step: int) -> list:
        """The manifest entry of a saved file, then GC beyond keep_last.
        Returns the (entry, path) of each file removed."""
        # re-saving a step (a replay after rollback/recovery) overwrites
        # the file; dedup the manifest entry so it appears once, as newest
        entries = [e for e in self.entries() if e.get("file") != fname]
        entries.append({"step": int(step), "file": fname,
                        "time_s": time.time(),
                        "size": os.path.getsize(path)})
        # GC: keep the newest keep_last, unlink the rest
        doomed, entries = entries[:-self.keep_last], entries[-self.keep_last:]
        self._write_manifest(entries)
        removed = []
        for e in doomed:
            p = os.path.join(self.directory, e["file"])
            try:
                os.unlink(p)
            except OSError:
                pass
            removed.append((e, p))
        return removed

    # -- restore with verified fallback -----------------------------------
    def latest_verified(self) -> Tuple[int, str]:
        """(step, path) of the newest checkpoint that passes checksum
        verification, falling back through older ones. Raises
        CheckpointError when none survive."""
        entries = self.entries()
        failures: List[str] = []
        for i, e in enumerate(reversed(entries)):
            path = os.path.join(self.directory, e["file"])
            try:
                meta = verify_checkpoint(path)
            except CheckpointError as exc:
                _bump("corrupt")
                failures.append(str(exc))
                self._record("checkpoint.corrupt", step=e.get("step", -1),
                             path=path, error=str(exc))
                continue
            _bump("verified")
            step = int(meta.get("step", e.get("step") or 0))
            if i > 0:
                _bump("fallback")
                self._record("checkpoint.fallback", step=step, path=path,
                             skipped=i)
            return step, path
        raise CheckpointError(
            f"no verified checkpoint survives in {self.directory!r} "
            f"({len(entries)} candidate(s); failures: {failures})")

    def restore_latest(self, model) -> Tuple[int, str]:
        """Restore the newest VERIFIED checkpoint into the model (in
        place). Returns (step, path)."""
        with get_tracer().span("checkpoint.restore") as sp:
            step, path = self.latest_verified()
            sp.set(step=int(step))
            # already verified above; skip the second full read
            restore_checkpoint(path, model, verify=False)
        _bump("restored")
        return step, path
