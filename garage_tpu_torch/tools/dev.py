"""The running dev cluster, as the smoke tools see it.

``tools/dev_cluster.sh`` writes three node configs under
``$GARAGE_TPU_DEV_DIR`` (default ``/tmp/garage_tpu_dev``); the tools that
drive the cluster (``smoke``, ``metadata_smoke``, ``cpu_profile``,
``device_timeline``, ``incident_dump``) read its S3, web, admin and RPC
addresses from those files, so a cluster on other ports (a test's) is
driven the same way.  The script's own configs carry the reference's
ports (S3 3900/3910/3920, admin 3903/3913/3923, ...).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

from ..testing.s3_client import S3Client

REPO = Path(__file__).resolve().parents[2]
NODES = 3


def base_dir() -> Path:
    return Path(os.environ.get("GARAGE_TPU_DEV_DIR", "/tmp/garage_tpu_dev"))


def _port(addr: str) -> int:
    return int(addr.rsplit(":", 1)[1])


class DevCluster:
    """The three nodes' configs, their ports, and the port's CLI."""

    def __init__(self, base: Optional[Path] = None):
        from ..utils.config import read_config

        self.base = Path(base) if base is not None else base_dir()
        self.configs = [self.base / f"node{i}" / "garage.toml"
                        for i in range(NODES)]
        missing = [str(c) for c in self.configs if not c.exists()]
        if missing:
            raise SystemExit(f"no dev cluster configs at {missing}: start "
                             "garage_tpu_torch/tools/dev_cluster.sh first")
        cfgs = [read_config(str(c)) for c in self.configs]
        self.s3_ports: List[int] = [_port(c.s3_api_bind_addr) for c in cfgs]
        self.admin_ports: List[int] = [_port(c.admin_api_bind_addr)
                                       for c in cfgs]
        self.web_ports: List[int] = [_port(c.web_bind_addr) for c in cfgs]
        self.rpc_addrs: List[str] = [c.rpc_bind_addr for c in cfgs]
        self.admin_token = cfgs[0].admin_token

    def cli(self, *args, node: int = 0) -> str:
        """`python -m garage_tpu_torch -c nodeN.toml *args`; its stdout,
        or RuntimeError with its output when it exits non-zero."""
        r = subprocess.run(
            [sys.executable, "-m", "garage_tpu_torch", "-c",
             str(self.configs[node]), *args],
            capture_output=True, text=True, cwd=str(REPO))
        if r.returncode != 0:
            raise RuntimeError(f"cli {args}: {r.stdout}\n{r.stderr}")
        return r.stdout

    def create_key(self, name: str) -> tuple:
        """(key id, secret) of a new key made through the CLI."""
        out = self.cli("key", "create", name)
        kid = [ln for ln in out.splitlines() if "Key ID" in ln][0].split()[-1]
        sec = [ln for ln in out.splitlines() if "Secret" in ln][0].split()[-1]
        return kid, sec

    def s3(self, node: int, kid: str, secret: str, session) -> S3Client:
        """A signing client of node `node`'s S3 port over `session`."""
        return S3Client(session, self.s3_ports[node], kid, secret)
