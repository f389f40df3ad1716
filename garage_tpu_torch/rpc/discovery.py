"""External peer discovery: Consul and Kubernetes.

Equivalent of reference src/rpc/consul.rs (230 LoC) and
src/rpc/kubernetes.rs (114 LoC): beyond bootstrap peers, a node can
register itself in an external catalog and learn its peers from it on
every discovery tick (ref rpc/system.rs:726-808).

Consul speaks the same wire format as the reference — the
`fr-deuxfleurs-garagehq-pubkey` service-meta key and both the `catalog`
(catalog/register) and `agent` (agent/service/register) publication APIs
(consul.rs:14,130-220) — so a mixed cluster's members can find each
other through one Consul.

Kubernetes uses the reference's CRD (group `deuxfleurs.fr`, kind
GarageNode, named by the node's hex pubkey, labelled
`garage.deuxfleurs.fr/service=<service_name>`, kubernetes.rs:14-26,45-114)
via the in-cluster API (service-account token + CA), no client library
needed.
"""

from __future__ import annotations

import logging
import os
import ssl
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("garage_tpu_torch.rpc.discovery")

META_PREFIX = "fr-deuxfleurs-garagehq"   # ref consul.rs:14 (wire compat)
K8S_GROUP = "deuxfleurs.fr"              # ref kubernetes.rs K8S_GROUP
K8S_VERSION = "v1"
K8S_PLURAL = "garagenodes"
SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def _split_addr(rpc_public_addr: str) -> Tuple[str, int]:
    """'host:port' → (host, port), with IPv6 brackets stripped so the
    published Address parses as a bare IP on the reference side too
    (consul.rs stores an IpAddr)."""
    host, _, port = rpc_public_addr.rpartition(":")
    return host.strip("[]"), int(port)


def _decode_pubkey(pubkey_hex: str) -> Optional[bytes]:
    try:
        pubkey = bytes.fromhex(pubkey_hex)
    except ValueError:
        return None
    return pubkey if len(pubkey) == 32 else None


class ConsulDiscovery:
    """Register in / query from a Consul catalog (ref consul.rs:76-220)."""

    def __init__(self, cfg: "ConsulDiscoveryConfig"):
        self.cfg = cfg
        self._session = None

    def _ssl(self):
        if not self.cfg.consul_http_addr.startswith("https"):
            return None
        if self.cfg.tls_skip_verify:
            ctx = ssl.create_default_context()
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
            return ctx
        ctx = ssl.create_default_context(cafile=self.cfg.ca_cert)
        if self.cfg.client_cert and self.cfg.client_key:
            ctx.load_cert_chain(self.cfg.client_cert, self.cfg.client_key)
        return ctx

    async def _ensure_session(self):
        if self._session is None:
            import aiohttp

            headers = {}
            if self.cfg.token:
                headers["x-consul-token"] = self.cfg.token
            self._session = aiohttp.ClientSession(
                headers=headers,
                timeout=aiohttp.ClientTimeout(total=10.0),
                connector=aiohttp.TCPConnector(ssl=self._ssl()),
            )
        return self._session

    async def get_nodes(self) -> List[Tuple[bytes, str]]:
        """→ [(node_id, "ip:port")] from the service catalog
        (ref consul.rs:130-159)."""
        s = await self._ensure_session()
        url = (f"{self.cfg.consul_http_addr}/v1/catalog/service/"
               f"{self.cfg.service_name}")
        async with s.get(url) as r:
            r.raise_for_status()
            entries = await r.json()
        out = []
        for ent in entries:
            pubkey_hex = (ent.get("ServiceMeta") or {}).get(
                f"{META_PREFIX}-pubkey"
            )
            addr = ent.get("ServiceAddress") or ent.get("Address")
            port = ent.get("ServicePort")
            if not (pubkey_hex and addr and port):
                logger.warning("skipping invalid Consul node spec: %r", ent)
                continue
            pubkey = _decode_pubkey(pubkey_hex)
            if pubkey is None:
                logger.warning("invalid pubkey in Consul meta: %r", pubkey_hex)
                continue
            out.append((pubkey, f"{addr}:{port}"))
        return out

    async def publish(self, node_id: bytes, hostname: str,
                      rpc_public_addr: str) -> None:
        """Register this node (ref consul.rs:163-220; same JSON bodies)."""
        s = await self._ensure_session()
        ip, port = _split_addr(rpc_public_addr)
        node = f"garage:{bytes(node_id)[:8].hex()}"
        tags = ["advertised-by-garage", hostname] + list(self.cfg.tags)
        meta = dict(self.cfg.meta)
        meta[f"{META_PREFIX}-pubkey"] = bytes(node_id).hex()
        meta[f"{META_PREFIX}-hostname"] = hostname
        if self.cfg.api == "catalog":
            url = f"{self.cfg.consul_http_addr}/v1/catalog/register"
            body = {
                "Node": node,
                "Address": ip,
                "Service": {
                    "ID": node,
                    "Service": self.cfg.service_name,
                    "Tags": tags,
                    "Meta": meta,
                    "Address": ip,
                    "Port": port,
                },
            }
        else:  # agent API
            url = (f"{self.cfg.consul_http_addr}"
                   "/v1/agent/service/register?replace-existing-checks")
            body = {
                "ID": node,
                "Name": self.cfg.service_name,
                "Tags": tags,
                "Address": ip,
                "Port": port,
                "Meta": meta,
            }
        async with s.put(url, json=body) as r:
            r.raise_for_status()

    async def close(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None


class KubernetesDiscovery:
    """GarageNode CRD registration/query via the in-cluster API
    (ref kubernetes.rs:26-114).  `api_base`/`token`/`ca` default to the
    pod's service account and are overridable for tests."""

    def __init__(self, cfg: "KubernetesDiscoveryConfig",
                 api_base: Optional[str] = None,
                 token: Optional[str] = None,
                 ca_cert: Optional[str] = None):
        self.cfg = cfg
        if api_base is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                raise RuntimeError(
                    "not in a Kubernetes pod (KUBERNETES_SERVICE_HOST unset) "
                    "and no api_base override given"
                )
            api_base = f"https://{host}:{port}"
        self.api_base = api_base.rstrip("/")
        if token is None and os.path.exists(f"{SA_DIR}/token"):
            with open(f"{SA_DIR}/token") as f:
                token = f.read().strip()
        self.token = token
        if ca_cert is None and os.path.exists(f"{SA_DIR}/ca.crt"):
            ca_cert = f"{SA_DIR}/ca.crt"
        self.ca_cert = ca_cert
        self._session = None

    def _crd_url(self, name: str = "") -> str:
        base = (f"{self.api_base}/apis/{K8S_GROUP}/{K8S_VERSION}"
                f"/namespaces/{self.cfg.namespace}/{K8S_PLURAL}")
        return f"{base}/{name}" if name else base

    async def _ensure_session(self):
        if self._session is None:
            import aiohttp

            headers = {}
            if self.token:
                headers["Authorization"] = f"Bearer {self.token}"
            sslctx = None
            if self.api_base.startswith("https"):
                sslctx = ssl.create_default_context(cafile=self.ca_cert)
            self._session = aiohttp.ClientSession(
                headers=headers,
                timeout=aiohttp.ClientTimeout(total=10.0),
                connector=aiohttp.TCPConnector(ssl=sslctx),
            )
        return self._session

    async def ensure_crd(self) -> None:
        """Create the GarageNode CRD if absent (ref kubernetes.rs:32-43);
        skipped when cfg.skip_crd (RBAC may forbid CRD management)."""
        if self.cfg.skip_crd:
            return
        s = await self._ensure_session()
        name = f"{K8S_PLURAL}.{K8S_GROUP}"
        url = (f"{self.api_base}/apis/apiextensions.k8s.io/v1"
               f"/customresourcedefinitions")
        async with s.get(f"{url}/{name}") as r:
            if r.status == 200:
                return
        crd = {
            "apiVersion": "apiextensions.k8s.io/v1",
            "kind": "CustomResourceDefinition",
            "metadata": {"name": name},
            "spec": {
                "group": K8S_GROUP,
                "names": {"kind": "GarageNode", "plural": K8S_PLURAL,
                          "singular": "garagenode"},
                "scope": "Namespaced",
                "versions": [{
                    "name": K8S_VERSION, "served": True, "storage": True,
                    "schema": {"openAPIV3Schema": {
                        "type": "object",
                        "properties": {"spec": {
                            "type": "object",
                            "properties": {
                                "hostname": {"type": "string"},
                                "address": {"type": "string"},
                                "port": {"type": "integer"},
                            },
                        }},
                    }},
                }],
            },
        }
        async with s.post(url, json=crd) as r:
            if r.status not in (200, 201, 409):
                logger.warning("GarageNode CRD create failed: %s", r.status)

    async def get_nodes(self) -> List[Tuple[bytes, str]]:
        """→ [(node_id, "ip:port")] from GarageNode objects labelled with
        our service name (ref kubernetes.rs:45-74)."""
        s = await self._ensure_session()
        sel = f"garage.{K8S_GROUP}/service={self.cfg.service_name}"
        async with s.get(self._crd_url(), params={"labelSelector": sel}) as r:
            r.raise_for_status()
            items = (await r.json()).get("items", [])
        out = []
        for node in items:
            name = node.get("metadata", {}).get("name", "")
            spec = node.get("spec", {})
            pubkey = _decode_pubkey(name)
            if pubkey is None:
                continue
            if spec.get("address") and spec.get("port"):
                out.append((pubkey, f"{spec['address']}:{spec['port']}"))
        return out

    async def publish(self, node_id: bytes, hostname: str,
                      rpc_public_addr: str) -> None:
        """Create-or-replace our GarageNode object (ref kubernetes.rs:76-114)."""
        s = await self._ensure_session()
        ip, port = _split_addr(rpc_public_addr)
        name = bytes(node_id).hex()
        obj = {
            "apiVersion": f"{K8S_GROUP}/{K8S_VERSION}",
            "kind": "GarageNode",
            "metadata": {
                "name": name,
                "labels": {
                    f"garage.{K8S_GROUP}/service": self.cfg.service_name,
                },
            },
            "spec": {"hostname": hostname, "address": ip, "port": port},
        }
        async with s.get(self._crd_url(name)) as r:
            if r.status == 200:
                old = await r.json()
                obj["metadata"]["resourceVersion"] = (
                    old["metadata"]["resourceVersion"]
                )
                async with s.put(self._crd_url(name), json=obj) as r2:
                    r2.raise_for_status()
                return
        async with s.post(self._crd_url(), json=obj) as r:
            r.raise_for_status()

    async def close(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None
