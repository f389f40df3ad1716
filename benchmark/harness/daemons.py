"""A deployment's nodes as daemons, one process each, configured through
the port's own CLI (``python -m garage_tpu_torch -c <config> ...``), as
an operator sets up ``script/dev-cluster.sh``'s nodes."""

from __future__ import annotations

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path
from typing import List, Optional

NODE = Path(__file__).resolve().parents[1] / "node.py"


def free_ports(n: int) -> List[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return json.dumps(v)
    if isinstance(v, list):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise TypeError(f"no TOML form for {v!r}")


def to_toml(d: dict) -> str:
    """A config dict of scalars, lists and one level of tables."""
    lines = [f"{k} = {_toml_value(v)}" for k, v in d.items()
             if not isinstance(v, dict)]
    for k, v in d.items():
        if isinstance(v, dict):
            lines.append(f"\n[{k}]")
            lines += [f"{kk} = {_toml_value(vv)}" for kk, vv in v.items()]
    return "\n".join(lines) + "\n"


class Daemons:
    def __init__(self, cfg: dict, root: Path, ctl: Optional[Path] = None,
                 fault: Optional[str] = None):
        self.n = int(cfg["nodes"])
        self.root, self.ctl, self.fault = Path(root), ctl, fault
        ports = free_ports(3 * self.n)
        self.rpc, self.s3, self.admin = (ports[0::3], ports[1::3], ports[2::3])
        self.configs, self.data_dirs, self.procs = [], [], []
        self.env = dict(os.environ, PYTHONPATH=str(NODE.parents[1]))
        for i in range(self.n):
            d = self.root / f"n{i}"
            d.mkdir(parents=True, exist_ok=True)
            c = dict(cfg["garage"])
            c.update(metadata_dir=str(d / "meta"), data_dir=str(d / "data"),
                     rpc_bind_addr=f"127.0.0.1:{self.rpc[i]}",
                     rpc_public_addr=f"127.0.0.1:{self.rpc[i]}",
                     rpc_secret="b3e4c7a1d2f6083a5b9c1e7d4f2a6c8b0e3d5f7a9c1b3d5e7f9a1c3e5b7d9f0a",
                     bootstrap_peers=[f"127.0.0.1:{p}" for p in self.rpc])
            c["s3_api"] = {"s3_region": "garage",
                           "api_bind_addr": f"127.0.0.1:{self.s3[i]}"}
            c["admin"] = {"api_bind_addr": f"127.0.0.1:{self.admin[i]}"}
            path = d / "garage.toml"
            path.write_text(to_toml(c))
            self.configs.append(path)
            self.data_dirs.append(d / "data")

    # --- processes ---

    def start(self) -> None:
        for i in range(self.n):
            args = [sys.executable, str(NODE), str(self.configs[i])]
            if self.ctl is not None:
                args += ["--control", str(self.ctl)]
            if self.fault is not None:
                args += ["--fault", str(self.fault)]
            with open(self.root / f"n{i}" / "daemon.log", "wb") as log:
                self.procs.append(subprocess.Popen(
                    args, env=self.env, stdout=log, stderr=subprocess.STDOUT))

    def log_tail(self, i: int, n: int = 30) -> str:
        text = (self.root / f"n{i}" / "daemon.log").read_text(errors="replace")
        return "\n".join(text.splitlines()[-n:])

    def check_alive(self, nodes=None) -> None:
        for i in (range(self.n) if nodes is None else nodes):
            rc = self.procs[i].poll()
            if rc is not None:
                raise RuntimeError(f"node {i} exited with {rc}; its log ends:\n"
                                   f"{self.log_tail(i)}")

    def kill(self, i: int) -> None:
        p = self.procs[i]
        if p.poll() is None:
            p.send_signal(signal.SIGKILL)
            p.wait()

    def stop(self, timeout: float = 30.0) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + timeout
        for p in self.procs:
            try:
                p.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    # --- operator commands and endpoints ---

    def cli(self, i: int, *args: str, timeout: float = 120) -> str:
        r = subprocess.run(
            [sys.executable, "-m", "garage_tpu_torch", "-c",
             str(self.configs[i]), *args], env=self.env, capture_output=True,
            text=True, timeout=timeout)
        if r.returncode != 0:
            raise RuntimeError(f"CLI {' '.join(args)} on node {i} exited "
                               f"{r.returncode}: {r.stdout[-800:]}{r.stderr[-800:]}")
        return r.stdout

    async def acli(self, i: int, *args: str) -> str:
        return await asyncio.to_thread(self.cli, i, *args)

    async def wait_listening(self, timeout: float = 180) -> None:
        deadline = time.monotonic() + timeout
        for i, port in enumerate(self.s3):
            while True:
                self.check_alive([i])
                try:
                    socket.create_connection(("127.0.0.1", port), 1).close()
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"node {i}'s S3 port never answered")
                    await asyncio.sleep(0.2)

    async def configure(self, bucket: str) -> tuple:
        """Layout over every node, a key, a bucket it may read and write;
        returns (key id, secret)."""
        ids = await asyncio.gather(*[self.acli(i, "node-id") for i in range(self.n)])
        for nid in ids:
            await self.acli(0, "layout", "assign", nid.strip().split("@")[0],
                            "-z", "dc1", "-c", "100G")
        await self.acli(0, "layout", "apply", "--version", "1")
        deadline = time.monotonic() + 120
        while "healthy" not in await self.acli(0, "status"):
            if time.monotonic() > deadline:
                raise RuntimeError("the cluster never reported healthy")
            await asyncio.sleep(0.5)
        made = await self.acli(0, "key", "create", "benchmark")
        key_id = next(l for l in made.splitlines() if "Key ID" in l).split()[-1]
        secret = next(l for l in made.splitlines() if "Secret" in l).split()[-1]
        await self.acli(0, "bucket", "create", bucket)
        await self.acli(0, "bucket", "allow", bucket, "--key", key_id,
                        "--read", "--write", "--owner")
        return key_id, secret

    async def scrub_pass(self, timeout: float = 180) -> None:
        """One scrub pass on every node at tranquility 0, as an operator
        runs ``worker set scrub-tranquility 0`` and ``repair scrub``;
        returns when each node's log says its pass is complete."""
        def done(i):
            log = (self.root / f"n{i}" / "daemon.log").read_text(errors="replace")
            return log.count("scrub complete")
        before = [done(i) for i in range(self.n)]
        await asyncio.gather(*[self.acli(i, "worker", "set", "scrub-tranquility", "0")
                               for i in range(self.n)])
        await asyncio.gather(*[self.acli(i, "repair", "scrub")
                               for i in range(self.n)])
        deadline = time.monotonic() + timeout
        while any(done(i) <= before[i] for i in range(self.n)):
            self.check_alive()
            if time.monotonic() > deadline:
                raise RuntimeError("a node's scrub pass never completed")
            await asyncio.sleep(0.2)

    def metrics_text(self, i: int) -> str:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.admin[i]}/metrics", timeout=30) as r:
            return r.read().decode()
