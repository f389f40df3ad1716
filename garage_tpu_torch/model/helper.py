"""Model helpers: bucket/key resolution and admin-side mutations.

Equivalent of reference src/model/helper/bucket.rs + key.rs (SURVEY.md
§2.6): bucket name→id resolution through the alias chains, existence and
permission checks, and the alias/permission update operations used by the
admin API and CLI (bucket.rs:40-546).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..utils.data import Uuid
from ..utils.error import GarageError
from .bucket_alias_table import BucketAlias, is_valid_bucket_name
from .bucket_table import Bucket
from .key_table import Key
from .permission import BucketKeyPerm


class NoSuchBucket(GarageError):
    status = 404


class NoSuchKey(GarageError):
    status = 404


class BucketAlreadyExists(GarageError):
    status = 409


class BucketNotEmpty(GarageError):
    status = 409


class GarageHelper:
    def __init__(self, garage):
        self.garage = garage

    # --- resolution (ref helper/bucket.rs:40-120) ---

    async def resolve_global_bucket_name(self, name: str) -> Optional[Uuid]:
        """Name → bucket id: a 64-hex name is interpreted as a raw id,
        otherwise the global alias table decides (bucket.rs:72-98)."""
        if len(name) == 64:
            try:
                return Uuid(bytes.fromhex(name))
            except ValueError:
                pass
        alias = await self.garage.bucket_alias_table.get(name, "")
        if alias is not None and alias.bucket_id() is not None:
            return alias.bucket_id()
        return None

    async def resolve_bucket(self, name: str, api_key: Optional[Key] = None) -> Uuid:
        """Global alias, then the key's local aliases (ref bucket.rs:100-140)."""
        if api_key is not None and api_key.params() is not None:
            local = api_key.params().local_aliases.get(name)
            if local is not None:
                return Uuid(local)
        bid = await self.resolve_global_bucket_name(name)
        if bid is None:
            raise NoSuchBucket(f"bucket {name!r} not found")
        return bid

    async def get_existing_bucket(self, bucket_id: Uuid) -> Bucket:
        b = await self.garage.bucket_table.get(bucket_id, "")
        if b is None or b.is_deleted():
            raise NoSuchBucket(f"bucket {bytes(bucket_id).hex()} not found")
        return b

    async def get_existing_key(self, key_id: str) -> Key:
        k = await self.garage.key_table.get(key_id, "")
        if k is None or k.is_deleted():
            raise NoSuchKey(f"key {key_id} not found")
        return k

    # --- admin mutations (ref helper/bucket.rs:150-546) ---

    async def create_bucket(self, name: str) -> Bucket:
        if not is_valid_bucket_name(name):
            raise GarageError(f"invalid bucket name {name!r}")
        existing = await self.resolve_global_bucket_name(name)
        if existing is not None:
            raise BucketAlreadyExists(f"bucket {name!r} already exists")
        bucket = Bucket.new()
        bucket.params().aliases.update(name, True)
        await self.garage.bucket_table.insert(bucket)
        await self.garage.bucket_alias_table.insert(
            BucketAlias.new(name, bucket.id)
        )
        return bucket

    async def delete_bucket(self, bucket_id: Uuid) -> None:
        """Delete an empty bucket: drop aliases + key grants + the row
        (ref admin/bucket.rs delete_bucket — refuses non-empty buckets)."""
        bucket = await self.get_existing_bucket(bucket_id)
        counts = await self.garage.object_counter.get_totals(bytes(bucket_id))
        mpu_counts = await self.garage.mpu_counter.get_totals(bytes(bucket_id))
        if (
            counts.get("objects", 0) > 0
            or counts.get("unfinished_uploads", 0) > 0
            or mpu_counts.get("uploads", 0) > 0
        ):
            raise BucketNotEmpty(
                f"bucket {bytes(bucket_id).hex()[:16]} is not empty: {counts}"
            )
        params = bucket.params()
        # drop global aliases
        for name, lww in list(params.aliases.items.items()):
            if lww.value:
                alias = await self.garage.bucket_alias_table.get(name, "")
                if alias is not None:
                    alias.state.update(None)
                    await self.garage.bucket_alias_table.insert(alias)
        # revoke key grants + local aliases
        for key_id in list(params.authorized_keys.items.keys()):
            try:
                key = await self.get_existing_key(key_id)
            except NoSuchKey:
                continue
            kp = key.params()
            kp.authorized_buckets.update(bytes(bucket_id), BucketKeyPerm())
            for alias, lww in list(kp.local_aliases.items.items()):
                if lww.value == bytes(bucket_id):
                    kp.local_aliases.update(alias, None)
            await self.garage.key_table.insert(key)
        from ..utils.crdt import Deletable

        bucket.state = Deletable.delete()
        await self.garage.bucket_table.insert(bucket)

    async def set_bucket_key_permissions(
        self, bucket_id: Uuid, key_id: str, perm: BucketKeyPerm
    ) -> None:
        """Grant/revoke, updating both sides of the bidirectional map
        (ref bucket.rs:280-340)."""
        bucket = await self.get_existing_bucket(bucket_id)
        key = await self.get_existing_key(key_id)
        bucket.params().authorized_keys.update(key_id, perm)
        key.params().authorized_buckets.update(bytes(bucket_id), perm)
        await self.garage.bucket_table.insert(bucket)
        await self.garage.key_table.insert(key)

    async def create_key(self, name: str = "unnamed") -> Key:
        key = Key.new(name)
        await self.garage.key_table.insert(key)
        return key

    async def delete_key(self, key: Key) -> None:
        """Revoke from all buckets then tombstone (ref helper/key.rs).
        Also clears the bucket-side (key_id, alias) local-alias mirrors:
        a stale mirror inflates bucket_name_count and lets the last-alias
        guard approve removing a bucket's last USABLE name."""
        params = key.params()
        if params is not None:
            for bid in list(params.authorized_buckets.items.keys()):
                bucket = await self.garage.bucket_table.get(Uuid(bid), "")
                if bucket is not None and not bucket.is_deleted():
                    bucket.params().authorized_keys.update(
                        key.key_id, BucketKeyPerm()
                    )
                    await self.garage.bucket_table.insert(bucket)
            for alias, lww in list(params.local_aliases.items.items()):
                if not lww.value:
                    continue
                bucket = await self.garage.bucket_table.get(
                    Uuid(lww.value), "")
                if bucket is not None and not bucket.is_deleted():
                    bucket.params().local_aliases.update(
                        (key.key_id, alias), False)
                    await self.garage.bucket_table.insert(bucket)
        from ..utils.crdt import Deletable

        key.state = Deletable.delete()
        await self.garage.key_table.insert(key)

    @staticmethod
    def bucket_name_count(bucket: Bucket) -> int:
        """How many live names (global + key-local aliases) the bucket
        has — the single source for every last-alias guard (HTTP admin
        and RPC admin must enforce the same invariant)."""
        p = bucket.params()
        return sum(
            1 for _n, l in p.aliases.items.items() if l.value
        ) + sum(
            1 for _k, l in p.local_aliases.items.items() if l.value
        )

    async def list_buckets(self, limit: int = 1000) -> List[Bucket]:
        """All non-deleted buckets (full-copy table → local range reads,
        iterating every partition)."""
        out = []
        seen = set()
        # full-copy replication: all rows are local; iterate the local tree
        data = self.garage.bucket_table.data
        for _k, v in data.store.items(b"", None):
            try:
                b = data.decode_entry(v)
            except Exception:
                continue
            if not b.is_deleted() and bytes(b.id) not in seen:
                seen.add(bytes(b.id))
                out.append(b)
                if len(out) >= limit:
                    break
        return out

    async def list_keys(self, limit: int = 1000) -> List[Key]:
        out = []
        data = self.garage.key_table.data
        for _k, v in data.store.items(b"", None):
            try:
                k = data.decode_entry(v)
            except Exception:
                continue
            if not k.is_deleted():
                out.append(k)
                if len(out) >= limit:
                    break
        return out
