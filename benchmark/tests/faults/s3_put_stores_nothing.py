"""A PutObject that acknowledges without storing anything."""

import hashlib

from garage_tpu_torch.api.s3 import put


async def save_stream(ctx, stream, *args, **kwargs):
    async for _chunk in stream:
        pass
    return hashlib.md5(b"").hexdigest(), 0


put.save_stream = save_stream
