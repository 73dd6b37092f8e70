"""The per-video job queue across hosts.

Counterpart of ``neuralstyletransferv1_tpu/parallel/jobqueue.py`` (the
port's own copy: it imports nothing of the JAX package). Frames split
across the cards of one host (``parallel/mesh.py``); videos split across
hosts through this queue, since videos are independent jobs of very
different lengths and dynamic claiming balances them where hosts share a
filesystem.

``JobQueue`` is a directory-backed queue safe across hosts sharing a POSIX
filesystem (NFS, Lustre, gcsfuse):

- enqueue: write ``tmp`` then ``os.rename`` into ``pending/`` — atomic
  publish, readers never see partial JSON;
- claim: ``os.rename(pending/x.json, running/x.json)`` — rename is atomic,
  exactly one claimant wins, losers get FileNotFoundError and try the next
  job;
- liveness: workers bump the running file's mtime (``heartbeat``); any
  worker may requeue jobs whose heartbeat is older than ``stale_secs``
  (host died mid-video) — the retry count rides inside the payload;
- terminal states land in ``done/`` / ``failed/`` with result/error merged
  into the payload.

Static fallback for hosts with NO shared filesystem:
``shard_static(items, host_id, num_hosts)`` (deterministic round-robin).

Used by ``apps/drive_videos.py`` (QUEUE_DIR / HOST_ID / NUM_HOSTS env
contract).
"""

from __future__ import annotations

import json
import os
import socket
import time
import uuid
from pathlib import Path

_STATES = ("pending", "running", "done", "failed")


def shard_static(items: list, host_id: int, num_hosts: int) -> list:
    """Deterministic round-robin shard for hosts without a shared FS."""
    if not (0 <= host_id < num_hosts):
        raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
    return list(items)[host_id::num_hosts]


def default_worker_id() -> str:
    return f"{socket.gethostname()}-{os.getpid()}"


class JobQueue:
    def __init__(self, root: str | Path):
        self.root = Path(root)
        for s in _STATES:
            (self.root / s).mkdir(parents=True, exist_ok=True)

    # -- producers ---------------------------------------------------------

    def enqueue(self, payload: dict, job_id: str | None = None) -> str:
        """Atomic publish into pending/. Returns the job id."""
        job_id = job_id or uuid.uuid4().hex[:12]
        rec = dict(payload)
        rec.setdefault("_id", job_id)
        rec.setdefault("_retries", 0)
        tmp = self.root / f".tmp-{job_id}-{uuid.uuid4().hex[:6]}"
        tmp.write_text(json.dumps(rec))
        os.rename(tmp, self.root / "pending" / f"{job_id}.json")
        return job_id

    def has(self, job_id: str) -> bool:
        return any((self.root / s / f"{job_id}.json").exists() for s in _STATES)

    def enqueue_unique(self, payload: dict, job_id: str) -> bool:
        """Enqueue unless the id exists in ANY state — re-running the same
        enqueue command on every host is then idempotent."""
        if self.has(job_id):
            return False
        self.enqueue(payload, job_id)
        return True

    # -- consumers ---------------------------------------------------------

    def claim(self, worker: str | None = None) -> tuple[str, dict] | None:
        """Claim the oldest pending job; None if the queue is drained.

        The atomic-rename race means concurrent claimants each end up with a
        DIFFERENT job (or None).
        """
        worker = worker or default_worker_id()
        pend = self.root / "pending"
        for f in sorted(pend.glob("*.json")):
            dst = self.root / "running" / f.name
            try:
                os.rename(f, dst)
            except (FileNotFoundError, OSError):
                continue  # someone else won this one
            rec = json.loads(dst.read_text())
            rec["_worker"] = worker
            rec["_claimed_at"] = time.time()
            dst.write_text(json.dumps(rec))
            return rec["_id"], rec
        return None

    def heartbeat(self, job_id: str) -> None:
        p = self.root / "running" / f"{job_id}.json"
        if p.exists():
            os.utime(p)

    def complete(self, job_id: str, result: dict | None = None) -> None:
        self._finish(job_id, "done", {"_result": result or {}})

    def fail(self, job_id: str, error: str, *, retry: bool = False,
             max_retries: int = 2) -> None:
        """Move to failed/, or back to pending/ when retry budget remains."""
        p = self.root / "running" / f"{job_id}.json"
        rec = json.loads(p.read_text())
        if retry and rec.get("_retries", 0) < max_retries:
            rec["_retries"] = rec.get("_retries", 0) + 1
            rec["_last_error"] = error
            rec.pop("_worker", None)
            tmp = self.root / f".tmp-{job_id}-{uuid.uuid4().hex[:6]}"
            tmp.write_text(json.dumps(rec))
            os.rename(tmp, self.root / "pending" / f"{job_id}.json")
            p.unlink()
        else:
            self._finish(job_id, "failed", {"_error": error})

    def _finish(self, job_id: str, state: str, extra: dict) -> None:
        p = self.root / "running" / f"{job_id}.json"
        rec = json.loads(p.read_text())
        rec.update(extra)
        rec["_finished_at"] = time.time()
        dst = self.root / state / f"{job_id}.json"
        tmp = self.root / f".tmp-{job_id}-{uuid.uuid4().hex[:6]}"
        tmp.write_text(json.dumps(rec))
        os.rename(tmp, dst)
        p.unlink()

    # -- maintenance -------------------------------------------------------

    def requeue_stale(self, stale_secs: float) -> list[str]:
        """Requeue running jobs whose heartbeat went quiet (worker died)."""
        out = []
        now = time.time()
        for f in (self.root / "running").glob("*.json"):
            try:
                if now - f.stat().st_mtime < stale_secs:
                    continue
                rec = json.loads(f.read_text())
            except (FileNotFoundError, json.JSONDecodeError):
                continue
            rec["_retries"] = rec.get("_retries", 0) + 1
            rec["_last_error"] = f"stale heartbeat (> {stale_secs}s)"
            rec.pop("_worker", None)
            jid = rec["_id"]
            tmp = self.root / f".tmp-{jid}-{uuid.uuid4().hex[:6]}"
            tmp.write_text(json.dumps(rec))
            try:
                os.rename(tmp, self.root / "pending" / f"{jid}.json")
                f.unlink()
                out.append(jid)
            except OSError:
                tmp.unlink(missing_ok=True)
        return out

    def counts(self) -> dict:
        return {s: len(list((self.root / s).glob("*.json"))) for s in _STATES}

    def drained(self) -> bool:
        c = self.counts()
        return c["pending"] == 0 and c["running"] == 0

    # -- worker loop -------------------------------------------------------

    def work(self, fn, *, worker: str | None = None, poll_secs: float = 2.0,
             stale_secs: float = 900.0, max_jobs: int = 0) -> int:
        """Claim-process loop until the queue drains. Returns #processed.

        ``fn(payload) -> dict|None``; raise to fail the job (retried up to
        the retry budget). Run the SAME loop on every host sharing the
        queue dir — claiming balances the load dynamically.
        """
        worker = worker or default_worker_id()
        n = 0
        while True:
            self.requeue_stale(stale_secs)
            got = self.claim(worker)
            if got is None:
                if self.drained() or (max_jobs and n >= max_jobs):
                    return n
                time.sleep(poll_secs)
                continue
            jid, rec = got
            try:
                res = fn(rec)
                self.complete(jid, res)
            except Exception as e:  # noqa: BLE001 — job isolation
                self.fail(jid, f"{type(e).__name__}: {e}", retry=True)
            n += 1
            if max_jobs and n >= max_jobs:
                return n
