"""Daemon assembly — the `garage_tpu_torch server` entry point.

Equivalent of reference src/garage/server.rs:30-192 (SURVEY.md §2.9):
read config → build Garage → spawn background workers → start RPC
listener + membership loops → start S3/Admin/Web API servers → wait for
SIGINT/SIGTERM → graceful shutdown in reverse order (API servers first,
then workers with their 8s deadline, then the RPC system, then the DB).

The node's block codec runs on the GPU (`Server(config)`, `run_server`);
with `codec.backend` cuda or hybrid and no card the daemon raises at
start.  `Server(config, device="cpu")` runs the kernels' plain versions
and exists for the tests.  `codec.backend = "cpu"` is the native C++
floor and needs no card.
"""

from __future__ import annotations

import asyncio
import faulthandler
import logging
import signal
from typing import Optional

from .admin import AdminRpcHandler
from .api.admin_server import AdminApiServer
from .api.s3.api_server import S3ApiServer
from .model import Garage
from .utils.config import Config, read_config
from .web import WebServer

logger = logging.getLogger("garage_tpu_torch.server")


class Server:
    """A running node with all its services (also used in-process by the
    integration test harness)."""

    def __init__(self, config: Config, device="cuda"):
        self.config = config
        self.garage = Garage(config, device=device)
        self.admin_rpc = AdminRpcHandler(self.garage)
        self.s3: Optional[S3ApiServer] = None
        self.admin: Optional[AdminApiServer] = None
        self.web: Optional[WebServer] = None
        self.k2v = None

    async def start(self) -> None:
        g = self.garage
        g.spawn_workers()
        await g.system.run()  # binds the RPC socket + starts gossip loops
        if self.config.s3_api_bind_addr:
            self.s3 = S3ApiServer(g)
            await self.s3.start(self.config.s3_api_bind_addr)
        if self.config.admin_api_bind_addr:
            self.admin = AdminApiServer(g)
            await self.admin.start(self.config.admin_api_bind_addr)
        if self.config.web_bind_addr:
            self.web = WebServer(g)
            await self.web.start(self.config.web_bind_addr)
        if self.config.k2v_api_bind_addr:
            from .api.k2v_server import K2VApiServer

            self.k2v = K2VApiServer(g)
            await self.k2v.start(self.config.k2v_api_bind_addr)
        logger.info(
            "node %s up (rpc %s)",
            bytes(g.system.id).hex()[:16],
            self.config.rpc_bind_addr,
        )

    async def stop(self) -> None:
        # reverse order of start (ref server.rs:135-171).  The S3 front
        # door drains first: new requests shed typed while the in-flight
        # set finishes inside api.drain_timeout, with the drain state
        # gossiped so sibling gateways absorb load before the socket
        # closes (docs/ROBUSTNESS.md "Geo-WAN & gateway failover")
        if self.s3 is not None:
            try:
                await self.s3.drain()
            except Exception:
                logger.exception("S3 drain failed; closing hard")
        for srv in (self.k2v, self.web, self.admin, self.s3):
            if srv is not None:
                await srv.stop()
        await self.garage.shutdown()


async def run_server(config_path: str) -> None:
    # SIGUSR1 → dump all thread stacks to stderr (live-debug a stuck node)
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    config = read_config(config_path)
    server = Server(config)
    await server.start()

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:  # pragma: no cover
            pass
    await stop.wait()
    logger.info("shutting down…")
    await server.stop()
