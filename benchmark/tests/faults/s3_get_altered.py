"""A GetObject whose body has one byte altered where the block is read."""

from garage_tpu_torch.block.manager import BlockManager

_orig = BlockManager.rpc_get_block_streaming


async def rpc_get_block_streaming(self, h, *args, **kwargs):
    first = True
    async for chunk in _orig(self, h, *args, **kwargs):
        if first and len(chunk):
            chunk = bytes([chunk[0] ^ 1]) + bytes(chunk[1:])
            first = False
        yield chunk


BlockManager.rpc_get_block_streaming = rpc_get_block_streaming
