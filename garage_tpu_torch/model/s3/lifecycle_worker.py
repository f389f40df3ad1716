"""Lifecycle worker — applies bucket lifecycle rules (expiration and
abort-incomplete-multipart-upload) in a daily resumable pass.

Equivalent of reference src/model/s3/lifecycle_worker.rs:36-103:
  - one pass per UTC day over the whole local object table, in tree-key
    order (hash(bucket) ‖ key), batches of 100 objects per work() step;
  - per object: load its bucket (cached while the walk stays in the same
    bucket — the walk is bucket-hash-ordered so each bucket is one
    contiguous run), apply each enabled rule whose prefix/size filters
    match:
      * Expiration Days/Date → insert a DeleteMarker tombstone version,
      * AbortIncompleteMultipartUpload DaysAfterInitiation → mark old
        Uploading versions Aborted (the object-table hook cascades the
        cleanup to version/block_ref rows);
  - buckets with no enabled rules are skipped wholesale by jumping the
    position cursor past the bucket's 32-byte hash prefix;
  - the last completed date persists (Persister) so restarts within the
    same day do not rerun, and mid-pass restarts rerun idempotently from
    the start of the day (expiring twice is a no-op: the tombstone is
    already the newest version).
"""

from __future__ import annotations

import asyncio
import datetime
import logging
from typing import Optional

from ...utils.background import Worker, WorkerState
from ...utils.crdt import now_msec
from ...utils.data import gen_uuid
from ...utils.migrate import Migrated
from ...utils.persister import Persister
from .object_table import Object, ObjectVersion, ObjectVersionData

logger = logging.getLogger("garage_tpu_torch.model.lifecycle")

BATCH = 100  # objects per work() step (ref lifecycle_worker.rs:163)


class LifecycleWorkerPersisted(Migrated):
    """ref lifecycle_worker.rs v090::LifecycleWorkerPersisted."""

    VERSION_MARKER = b"GT01lwp"

    def __init__(self, last_completed: Optional[str] = None):
        self.last_completed = last_completed

    def fields(self):
        return [self.last_completed]

    @classmethod
    def from_fields(cls, b):
        return cls(*b)


def today() -> datetime.date:
    """UTC date; module-level so tests can monkeypatch time travel."""
    return datetime.datetime.now(datetime.timezone.utc).date()


def next_date(ts_ms: int) -> datetime.date:
    """Date after the timestamp's date — a version 'counts' from the first
    full day after it was written (ref lifecycle_worker.rs next_date)."""
    d = datetime.datetime.fromtimestamp(
        ts_ms / 1000.0, tz=datetime.timezone.utc
    ).date()
    return d + datetime.timedelta(days=1)


def parse_lifecycle_date(s: str) -> Optional[datetime.date]:
    try:
        return datetime.datetime.fromisoformat(s.replace("Z", "+00:00")).date()
    except ValueError:
        return None


def _midnight_after(d: datetime.date) -> float:
    nxt = d + datetime.timedelta(days=1)
    dt = datetime.datetime.combine(
        nxt, datetime.time(0, 0), tzinfo=datetime.timezone.utc
    )
    return dt.timestamp()


class LifecycleWorker(Worker):
    def __init__(self, garage, persister: Persister):
        self.garage = garage
        self.persister = persister
        st = persister.load()
        last = (
            datetime.date.fromisoformat(st.last_completed)
            if st is not None and st.last_completed
            else None
        )
        t = today()
        if last is not None and last >= t:
            self.date: Optional[datetime.date] = None  # completed for today
            self.last_completed = last
        else:
            self._start(t)
            self.last_completed = last

    def _start(self, date: datetime.date) -> None:
        logger.info("starting lifecycle pass for %s", date)
        self.date = date
        self.pos = b""
        self.counter = 0
        self.objects_expired = 0
        self.mpu_aborted = 0
        self._bucket_cache: Optional[tuple] = None  # (bucket_id_bytes, bucket)

    def name(self) -> str:
        return "Object lifecycle worker"

    async def work(self) -> WorkerState:
        if self.date is None:
            return WorkerState.IDLE
        data = self.garage.object_table.data
        for _ in range(BATCH):
            nxt = data.store.get_gt(self.pos)
            if nxt is None:
                logger.info(
                    "lifecycle pass for %s done: %d expired, %d mpu aborted",
                    self.date, self.objects_expired, self.mpu_aborted,
                )
                self.last_completed = self.date
                self.persister.save(
                    LifecycleWorkerPersisted(self.date.isoformat())
                )
                self.date = None
                return WorkerState.IDLE
            key, val = nxt
            try:
                obj = data.decode_entry(val)
            except Exception:
                logger.exception("lifecycle: undecodable object row")
                self.pos = key
                continue
            skip_bucket = await self.process_object(obj)
            self.counter += 1
            self.status().progress = f"{self.counter} objects"
            if skip_bucket:
                # jump past every remaining key of this bucket: tree keys
                # are hash(bucket_id)(32B) ‖ object key
                self.pos = max(key, key[:32] + b"\xff" * 8)
            else:
                self.pos = key
        return WorkerState.BUSY

    async def process_object(self, obj: Object) -> bool:
        """Apply the bucket's rules to one object; True = the whole bucket
        can be skipped (no enabled rules / bucket gone)."""
        if not any(v.is_data() or v.is_uploading() for v in obj.versions()):
            return False
        bid = bytes(obj.bucket_id)
        if self._bucket_cache is not None and self._bucket_cache[0] == bid:
            bucket = self._bucket_cache[1]
        else:
            bucket = await self.garage.bucket_table.get(obj.bucket_id, "")
            if bucket is None or bucket.is_deleted():
                logger.warning("lifecycle: object in missing bucket %s", bid.hex()[:16])
                return True
            self._bucket_cache = (bid, bucket)
        rules = bucket.params().lifecycle_config.value or []
        if not any(r.get("enabled") for r in rules):
            return True

        now_date = self.date
        for rule in rules:
            if not rule.get("enabled"):
                continue
            prefix = rule.get("prefix") or ""
            if prefix and not obj.key.startswith(prefix):
                continue

            days = rule.get("expiration_days")
            at_date = rule.get("expiration_date")
            if days is not None or at_date:
                cur = obj.last_data_version()
                if cur is not None and self._size_match(cur, rule):
                    if days is not None:
                        expired = (
                            now_date - next_date(cur.timestamp)
                        ).days >= days
                    else:
                        exp = parse_lifecycle_date(at_date)
                        if exp is None:
                            logger.warning(
                                "invalid lifecycle date %r in bucket %s",
                                at_date, bid.hex()[:16],
                            )
                            expired = False
                        else:
                            expired = now_date >= exp
                    if expired:
                        marker = ObjectVersion(
                            gen_uuid(),
                            max(now_msec(), cur.timestamp + 1),
                            ["complete", ObjectVersionData.delete_marker()],
                        )
                        logger.info("lifecycle: expiring %s", obj.key)
                        await self.garage.object_table.insert(
                            Object(obj.bucket_id, obj.key, [marker])
                        )
                        self.objects_expired += 1

            abort_days = rule.get("abort_incomplete_days")
            if abort_days is not None:
                from .object_table import abort_uploads

                n = await abort_uploads(
                    self.garage.object_table, obj,
                    lambda v: (now_date - next_date(v.timestamp)).days
                    >= abort_days,
                )
                if n:
                    logger.info(
                        "lifecycle: aborting %d stale upload(s) of %s",
                        n, obj.key,
                    )
                    self.mpu_aborted += n
        return False

    @staticmethod
    def _size_match(version: ObjectVersion, rule: dict) -> bool:
        size = version.size()
        gt, lt = rule.get("size_gt"), rule.get("size_lt")
        if gt is not None and not size > gt:
            return False
        if lt is not None and not size < lt:
            return False
        return True

    async def wait_for_work(self) -> None:
        if self.date is not None:
            return
        base = self.last_completed or today()
        delay = max(1.0, _midnight_after(base) - datetime.datetime.now(
            datetime.timezone.utc
        ).timestamp())
        # wake at most every 10 s so time-travel tests and shutdown stay
        # responsive (the reference sleeps the full interval; our Worker
        # protocol re-polls work() which is a cheap IDLE)
        await asyncio.sleep(min(delay, 10.0))
        t = today()
        if self.last_completed is None or self.last_completed < t:
            self._start(t)
